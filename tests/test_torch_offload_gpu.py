"""Remat "offload" and the offloaded optimizer on the card.

Every test here is ``gpu``-marked and skips without a card; the file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_offload_gpu.py

- "offload" gives the gradients of "dots" and of no remat bit for bit
  on a 2-layer GPT at GPT-2 xl's widths (bf16 params, the flash
  kernels), its products in pinned host memory between the forward and
  the backward;
- its host pool is made at the first step and reused (no growth);
- an offloaded 8-bit Adam (its int8 moments streamed to the card for
  the fused kernel) trains bit for bit as one kept on the card, its
  moved leaves pinned host tensors between steps;
- a ``Trainer(checkpoint_dir=..., offload_optimizer=True)`` snapshot
  restores bit for bit into a fresh trainer, and the moved leaves stay
  in host memory;
- on an ("fsdp", 1) mesh of an NCCL world of one, ``offload_optimizer``
  moves the ``MeshOptimizer``'s 8-bit moments and trains bit for bit as
  the same mesh without it.
"""

import dataclasses
import glob
import os
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models.convert import leaf_bytes, train_state_leaves
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.optim import adam8bit, adamw, bf16_master_weights
from dlrover_tpu_torch.train.trainer import Trainer

# GPT-2 xl's widths (25 heads of 64), two layers, bf16 params.
XL2 = dataclasses.replace(GPTConfig.gpt2_xl(), num_layers=2,
                          param_dtype=torch.bfloat16, attn_impl="pallas")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the flash kernels, pinned memory "
                    "and CUDA streams)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def tokens(b=2, s=1024, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 50257, (b, s))).cuda()


def grads(policy):
    cfg = dataclasses.replace(XL2, remat=policy is not None,
                              remat_policy=policy or "nothing")
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
    t = tokens()
    loss_fn(model(t), t).backward()
    torch.cuda.synchronize()
    return {n: p.grad for n, p in model.named_parameters()}, model


@pytest.mark.gpu
def test_offload_equals_dots_bit_for_bit(cuda_device):
    want, _ = grads(None)
    dots, _ = grads("dots")
    got, model = grads("offload")
    for name, g in got.items():
        assert torch.equal(g, dots[name]), name
        assert torch.equal(g, want[name]), name
    pool = model.remat.pool
    moved = pool.take_copy_stats()
    # qkv 4800 + proj 1600 + up 6400 + down 1600 values a token, bf16.
    per_layer = 2 * 1024 * 14400 * 2
    assert moved["out_bytes"] == moved["in_bytes"] == 2 * per_layer
    assert moved["out_ms"] > 0 and moved["in_ms"] > 0
    assert all(buf.is_pinned() for buf, _ in pool._slabs.values())


@pytest.mark.gpu
def test_offload_pool_is_reused(cuda_device):
    cfg = dataclasses.replace(XL2, remat=True, remat_policy="offload")
    model = GPT(cfg, device="cuda")
    t = tokens()
    sizes, slabs = [], None
    for _ in range(3):
        loss_fn(model(t), t).backward()
        torch.cuda.synchronize()
        sizes.append(model.remat.pool.nbytes)
        ptrs = [buf.data_ptr() for buf, _ in model.remat.pool._slabs.values()]
        assert slabs is None or ptrs == slabs
        slabs = ptrs
    assert sizes[0] > 0 and sizes == [sizes[0]] * 3


def _trainer(opt, offload, ckpt_dir="", seed=0):
    cfg = dataclasses.replace(GPTConfig.tiny(), param_dtype=torch.bfloat16,
                              d_model=128, num_heads=2, attn_impl="pallas")
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(seed))
    batch = np.random.default_rng(1).integers(0, 256, (4, 64))
    return Trainer(model, opt, lambda m, p, b: loss_fn(m(b), b), batch,
                   device="cuda", checkpoint_dir=ckpt_dir, persist_every=2,
                   offload_optimizer=offload), batch


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["adam8bit", "bf16_adamw"])
def test_offloaded_optimizer_trains_as_on_the_card(cuda_device, name):
    make = {"adam8bit": lambda: adam8bit(1e-2),
            "bf16_adamw": lambda: bf16_master_weights(adamw(1e-2))}[name]
    runs = []
    for offload in (False, True):
        t, batch = _trainer(make(), offload)
        state = t.state
        losses = []
        for _ in range(4):
            state, m = t.train_step(state, torch.from_numpy(batch).cuda())
            losses.append(float(m["loss"]))
            if offload:
                moved = t.state["opt"].moved
                assert moved and all(x.device.type == "cpu" and x.is_pinned()
                                     for x in moved)
        runs.append((losses, {n: p.detach().clone() for n, p in
                              t.module.named_parameters()}))
    assert runs[0][0] == runs[1][0] and runs[1][0][-1] < runs[1][0][0]
    assert all(torch.equal(p, runs[0][1][n]) for n, p in runs[1][1].items())


@pytest.mark.gpu
def test_offloaded_checkpoint_restores_bit_for_bit(cuda_device, tmp_path,
                                                   monkeypatch):
    job = f"gpu-off-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
    a, batch = _trainer(adam8bit(1e-2), True, str(tmp_path))
    try:
        a.fit(iter([batch] * 2), steps=2)
        want = {leaf.path: leaf_bytes(leaf).cpu()
                for leaf in train_state_leaves(a.state)}
        b, _ = _trainer(adam8bit(1e-2), True, str(tmp_path), seed=1)
        assert b.restore() == 2
        got = {leaf.path: leaf_bytes(leaf).cpu()
               for leaf in train_state_leaves(b.state)}
        assert got.keys() == want.keys()
        assert all(torch.equal(got[p], want[p]) for p in want)
        assert all(x.device.type == "cpu" and x.is_pinned()
                   for x in b.state["opt"].moved)
        b.close()
    finally:
        a.close()
        for path in glob.glob(f"/dev/shm/ckpt_{job}_*"):
            os.unlink(path)


@pytest.mark.gpu
def test_offload_on_an_fsdp_mesh_of_one(cuda_device, monkeypatch):
    """``accelerate_on_mesh`` on ("fsdp", 1) of an NCCL world of one
    (MASTER_ADDR / PORT, RANK, WORLD_SIZE set here): with
    ``offload_optimizer=True`` the 8-bit moments lie pinned on the host
    between steps, move in and out once a step, and four steps' losses
    and the parameters equal the same mesh's without offload bit for
    bit."""
    import socket

    import torch.distributed as dist

    from dlrover_tpu_torch.accel import accelerate_on_mesh
    from dlrover_tpu_torch.accel import mesh as mesh_mod

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    cfg = dataclasses.replace(GPTConfig.tiny(), param_dtype=torch.bfloat16,
                              d_model=128, num_heads=2, attn_impl="pallas")
    batch = np.random.default_rng(1).integers(0, 256, (4, 64))
    runs = []
    try:
        m = mesh_mod.create_mesh([("fsdp", 1)], torch.device("cuda", 0))
        for offload in (False, True):
            model = GPT(cfg, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(0))
            res = accelerate_on_mesh(
                model, adam8bit(1e-2), batch,
                lambda mod, p, b: loss_fn(mod(b), b), m, device="cuda",
                offload_optimizer=offload)
            t = torch.from_numpy(res.local_batch(batch)).cuda()
            losses = [float(res.train_step(res.state, t)[1]["loss"])
                      for _ in range(4)]
            if offload:
                opt = res.state["opt"]
                assert type(opt.inner).__name__ == "MeshOptimizer"
                assert opt.moved and all(x.device.type == "cpu"
                                         and x.is_pinned()
                                         for x in opt.moved)
                stats = opt.take_copy_stats()
                assert stats["in_bytes"] == stats["out_bytes"] == \
                    4 * opt.nbytes
            runs.append((losses, {n: p.detach().clone() for n, p in
                                  res.module.named_parameters()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert runs[0][0] == runs[1][0] and runs[1][0][-1] < runs[1][0][0]
    assert all(torch.equal(p.full_tensor() if hasattr(p, "full_tensor")
                           else p, runs[0][1][n].full_tensor()
                           if hasattr(runs[0][1][n], "full_tensor")
                           else runs[0][1][n])
               for n, p in runs[1][1].items())
