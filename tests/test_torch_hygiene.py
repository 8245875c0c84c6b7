"""Rules the PyTorch port keeps: no JAX, the card by default, sm_90a.

- No module of ``dlrover_tpu_torch/``, and not ``chip_smoke.py``, imports
  jax, flax, optax, ml_dtypes or anything of ``dlrover_tpu``: the master
  core, its wire, chaos and observability included.
- Entry points run on CUDA unless the caller asks for the CPU; without
  a card they raise instead of falling back.
- The kernel build targets Hopper's ``sm_90a`` (checked without nvcc).
- A head_dim-128 input goes to the head_dim-128 kernels, never to a
  plain version or another width, and any other head_dim raises.
"""

import ast
import contextlib
import os

import pytest
import torch

from dlrover_tpu_torch.accel import auto_accelerate
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
from dlrover_tpu_torch.ops import attention, build
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.train import init_training
from dlrover_tpu_torch.train.data import DevicePrefetchIterator
from dlrover_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "dlrover_tpu")


def port_sources():
    pkg = os.path.join(REPO, "dlrover_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", list(port_sources()), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_jax_or_reference_package_imports(path):
    bad = sorted(set(imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_walk_sees_the_whole_package():
    names = {os.path.relpath(p, REPO) for p in port_sources()}
    assert "dlrover_tpu_torch/ops/attention.py" in names
    assert "dlrover_tpu_torch/optim/low_bit.py" in names
    assert "dlrover_tpu_torch/models/convert.py" in names
    assert "dlrover_tpu_torch/models/llama.py" in names
    assert "dlrover_tpu_torch/models/remat.py" in names
    assert "dlrover_tpu_torch/train/trainer.py" in names
    assert "dlrover_tpu_torch/train/checkpoint/engine.py" in names
    assert "dlrover_tpu_torch/agent/ckpt_saver.py" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("sub", ["master", "master/monitor", "chaos",
                                 "observability", "common", "agent"])
def test_walk_sees_the_control_plane(sub):
    """The master core, its wire and what it imports are walked by the
    import check like the rest of the package."""
    names = {os.path.relpath(p, REPO) for p in port_sources()}
    pkg = os.path.join(REPO, "dlrover_tpu_torch", sub)
    mods = sorted(f for f in os.listdir(pkg) if f.endswith(".py"))
    assert mods, sub
    for f in mods:
        assert f"dlrover_tpu_torch/{sub}/{f}" in names
    want = {"master": ("servicer.py", "master.py", "main.py", "rendezvous.py",
                       "state_store.py", "node_manager.py", "kv_store.py"),
            "master/monitor": ("speed_monitor.py", "error_monitor.py"),
            "chaos": ("injector.py", "sites.py"),
            "observability": ("events.py",),
            "common": ("rpc.py", "wire.py", "messages.py", "node.py",
                       "lockdep.py"),
            "agent": ("master_client.py",)}[sub]
    assert set(want) <= set(mods), sub


def test_import_check_catches_a_planted_import(tmp_path):
    """The walk's import check finds each forbidden root, in both import
    forms, as a port module would write it."""
    path = tmp_path / "planted.py"
    path.write_text("import torch\nimport jax.numpy as jnp\n"
                    "from dlrover_tpu.models import llama\n"
                    "from . import sibling\n")
    assert sorted(set(imported_roots(str(path))) & set(FORBIDDEN)) == [
        "dlrover_tpu", "jax"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def loss(module, params, batch):
    return loss_fn(module(batch), batch)


def tiny_model():
    return GPT(GPTConfig.tiny(), device="cpu")


def test_trainer_raises_without_cuda(no_cuda, tmp_path):
    for kwargs in ({}, {"checkpoint_dir": str(tmp_path)}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(tiny_model(), adamw(1e-3), loss,
                    torch.zeros(2, 8, dtype=torch.long), **kwargs)
    assert not list(tmp_path.iterdir())


def test_auto_accelerate_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        auto_accelerate(tiny_model(), adamw(1e-3),
                        torch.zeros(2, 8, dtype=torch.long), loss)


def test_other_entry_points_raise_without_cuda(no_cuda):
    for make in (lambda: init_training(),
                 lambda: GPT(GPTConfig.tiny()),
                 lambda: Llama(LlamaConfig.tiny()),
                 lambda: DevicePrefetchIterator(iter([]))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_build_command_targets_sm90a():
    cmd = build.nvcc_command("flash_attn", "/dev/null")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-1] == build.source_path("flash_attn")
    assert os.path.exists(cmd[-1])


def test_adam8bit_kernels_have_a_source():
    cmd = build.nvcc_command("adam8bit", "/dev/null")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert os.path.exists(cmd[-1])


def test_adam8bit_raises_on_a_non_cuda_device():
    from dlrover_tpu_torch.optim import low_bit

    g = torch.zeros(4, device="meta")
    state = low_bit.QTensor(torch.zeros(1, 256, dtype=torch.int8),
                            torch.zeros(1))
    with pytest.raises(ValueError, match="no adam8bit kernel"):
        low_bit.adam8_update([g], state, state, torch.ones(2), (4,),
                             low_bit._Hyper(1e-3, 0.9, 0.999, 1e-8, 0.0, 256))


def test_flash_source_exports_every_entry():
    """Each C entry the wrapper binds (head_dim 64 and 128) is made by the
    source's FLASH_ENTRIES macro."""
    with open(build.source_path("flash_attn")) as f:
        text = f.read()
    for suffix, d in (("", 64), ("_d128", 128)):
        assert f"FLASH_ENTRIES({suffix}, {d})" in text
    assert sorted(attention._SIGNATURES) == sorted(
        f"{k}{sfx}_bf16" for k in attention.KERNELS
        for sfx in ("", "_d128"))


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors taken for CUDA ones: each launch records its C entry
    instead of running; a plain version called raises."""
    launched = []
    monkeypatch.setattr(attention, "_on_cpu", lambda t: False)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(
        attention, "_launcher",
        lambda entry, q, k, tensors, causal: lambda: launched.append(entry))

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran for a card tensor")

    for name in ("_fwd_plain", "_bwd_dq_plain", "_bwd_dkv_plain"):
        monkeypatch.setattr(attention, name, plain)
    attention.reset_launch_counts()
    return launched


@pytest.mark.parametrize("d", [64, 128])
def test_card_tensors_launch_their_width_kernels(fake_card, d):
    q, k, v = (torch.zeros(1, 128, 2, d, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    attention.flash_attention(q, k, v).sum().backward()
    sfx = "" if d == 64 else "_d128"
    assert fake_card == [f"flash_fwd{sfx}_bf16", f"flash_bwd_dq{sfx}_bf16",
                         f"flash_bwd_dkv{sfx}_bf16"]
    assert attention.LAUNCHES == {
        name: int(name.endswith("_d128") == (d == 128))
        for name in attention.LAUNCHES}


@pytest.mark.parametrize("d", [32, 96, 256])
def test_card_tensors_of_other_widths_raise(fake_card, d):
    q = torch.zeros(1, 128, 2, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim|D in"):
        attention.flash_fwd(q, q, q)
    assert fake_card == []


def test_library_name_follows_the_source():
    path = build.library_path("flash_attn")
    assert os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(path).startswith("libflash_attn-")


def test_library_name_follows_the_included_headers(tmp_path, monkeypatch):
    """An edited header, included directly or through another header,
    names a new library; an unrelated file does not."""
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  # include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    (tmp_path / "c.cuh").write_text("// not included\n")
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    assert [os.path.basename(p) for p in build.sources("k")] == [
        "k.cu", "a.cuh", "b.cuh"]
    before = build.library_path("k")
    (tmp_path / "c.cuh").write_text("// edited\n")
    assert build.library_path("k") == before
    (tmp_path / "b.cuh").write_text("// two\n")
    assert build.library_path("k") != before


def test_flash_attn_hashes_its_hopper_header():
    names = [os.path.basename(p) for p in build.sources("flash_attn")]
    assert names == ["flash_attn.cu", "hopper.cuh"]


def test_flash_probe_variants_apply_to_the_source(tmp_path, monkeypatch):
    """Each ablation of ``ops/flash_probe.py`` still finds the text it
    replaces, once, in the committed kernel source."""
    from dlrover_tpu_torch.ops import flash_probe

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    for name in flash_probe.VARIANTS:
        out = flash_probe.variant_source(name)
        with open(os.path.join(out, "flash_attn.cu")) as f:
            text = f.read()
        assert ("g_clocks" in text) == (name in (
            "clocks", "dkv128_clocks", "dq128_clocks",
            "dq128_before_clocks")), name


def test_adam8_probe_variants_apply_to_the_source(tmp_path, monkeypatch):
    """Each ablation of ``ops/adam8_probe.py`` still finds the text it
    replaces (for ``copy``, the span of the arithmetic) in the committed
    kernel source, and changes it."""
    from dlrover_tpu_torch.ops import adam8_probe

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    with open(os.path.join(build.CSRC, "adam8bit.cu")) as f:
        committed = f.read()
    for name in adam8_probe.VARIANTS:
        out = adam8_probe.variant_source(name)
        with open(os.path.join(out, "adam8bit.cu")) as f:
            text = f.read()
        assert (text == committed) == (name == "committed"), name
        assert ("__fsqrt_rn(v)" in text) == (name not in (
            "copy", "no_sqrt_div")), name


def test_build_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert "build/" in ignored
