"""The port's ``offload``, ``bf16_master_weights``, ``agd`` and
``WeightedSAM`` against the JAX package's, on the CPU.

Both packages start from the JAX GPT tiny tree (seed 0, fp32 compute,
einsum attention; carried across with ``models/convert.py``) and see
the same numpy batches. The JAX side runs a plain optax loop (its
``offload`` without placement shardings is its inner transform: the
memory kinds it would move are held separately, through
``auto_accelerate(offload_optimizer=True)``, which places them on the
CPU too); the port runs ``auto_accelerate``'s train step, or
``WeightedSAM.step``.

Tolerances. Losses agree to 1e-5 and fp32 params and masters to 5e-5
after three steps, as in ``tests/test_torch_trainer.py``: fp32 sums
agree to their order, and Adam-like divisions by sqrt(v) turn the last
bits of near-zero gradients into percent-level differences of one
step's size (lr 1e-3). With bf16 params the model's gradients are bf16,
and the two packages round a few of them to the other side of a tie
(the tied embedding's two contributions are summed in bf16 in either
order): so ``bf16_master_weights`` is held to JAX's on the same seeded
bf16 gradients, fed to both, its masters to 5e-5 and its params to one
bf16 ulp of their value (at most 2^-7 relative; a master within an ulp
of a rounding tie may round to the other side). Offload moves bytes,
not math: with and without it the port's losses and params are equal
bit for bit.
"""

import dataclasses
import functools
import glob
import importlib
import os
import uuid

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.accel import ParallelSpec as JaxSpec
from dlrover_tpu.accel import auto_accelerate as jax_accelerate
from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.optim import WeightedSAM as JaxWSAM
from dlrover_tpu.optim import adam8bit as jax_adam8bit
from dlrover_tpu.optim import agd as jax_agd
from dlrover_tpu.optim import bf16_master_weights as jax_bf16
from dlrover_tpu.optim import offload as jax_offload
from dlrover_tpu_torch.accel import ParallelSpec, auto_accelerate
from dlrover_tpu_torch.accel.registry import ShardingRegistry
from dlrover_tpu_torch.models.convert import (
    params_from_flax,
    train_state_leaves,
)
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.optim import (
    WeightedSAM,
    adam8bit,
    adamw,
    agd,
    bf16_master_weights,
    offload,
)
from dlrover_tpu_torch.optim.offload import (
    MIN_OFFLOAD_ELEMS,
    OffloadOptimizer,
    offloadable,
)
from dlrover_tpu_torch.train.checkpoint import engine as port_engine
from dlrover_tpu_torch.train.trainer import Trainer

LOSS_TOL, PARAM_TOL = 1e-5, 5e-5
BF16_ULP = 2.0 ** -7
STEPS = 3


def batches(n=STEPS, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (4, 32), dtype=np.int32) for _ in range(n)]


def jax_cfg(param_dtype=jnp.float32):
    return dataclasses.replace(jgpt.GPTConfig.tiny(), dtype=jnp.float32,
                               param_dtype=param_dtype)


@functools.lru_cache(maxsize=None)
def jax_tree(param_dtype="float32"):
    """The JAX GPT tiny's params from seed 0, as numpy; readers copy."""
    variables = jgpt.GPT(jax_cfg(getattr(jnp, param_dtype))).init(
        jax.random.PRNGKey(0), jnp.asarray(batches(1)[0]))
    return jax.tree_util.tree_map(np.asarray,
                                  nn.meta.unbox(variables["params"]))


def jax_run(tx, param_dtype="float32", steps=STEPS):
    """(losses, final params as the port's state_dict) of a plain optax
    loop over ``batches()``."""
    model = jgpt.GPT(jax_cfg(getattr(jnp, param_dtype)))
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree(param_dtype))

    def loss(p, toks):
        return jgpt.loss_fn(model.apply({"params": p}, toks), toks)

    @jax.jit
    def step(params, state, toks):
        lv, grads = jax.value_and_grad(loss)(params, toks)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, lv

    state, losses = tx.init(params), []
    for toks in batches(steps):
        params, state, lv = step(params, state, jnp.asarray(toks))
        losses.append(float(lv))
    return losses, params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           params)), state


def port_model(param_dtype="float32"):
    cfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32,
                              param_dtype=getattr(torch, param_dtype))
    model = GPT(cfg, device="cpu")
    model.load_state_dict(params_from_flax(jax_tree(param_dtype)))
    return model


def token_loss(module, params, batch):
    return loss_fn(module(batch), batch)


def port_run(opt, param_dtype="float32", steps=STEPS, **accel):
    """(losses, final state_dict, the accelerate result) of the port's
    train step over ``batches()``."""
    res = auto_accelerate(port_model(param_dtype), opt, batches(1)[0],
                          token_loss, spec=ParallelSpec(), device="cpu",
                          **accel)
    state, losses = res.state, []
    for toks in batches(steps):
        state, m = res.train_step(state, torch.from_numpy(toks).long())
        losses.append(float(m["loss"]))
    return losses, {n: t.detach().clone() for n, t in
                    res.module.state_dict().items()}, res


def assert_params_close(got, want, rtol=PARAM_TOL, adam8=False):
    """Each value within the tolerances; under the 8-bit Adam, all but
    0.1% of them, and those within a step's size (lr 1e-3) a step: its
    int8 moments may differ by one on 0.1% of the entries
    (``tests/test_torch_optim.py``), which moves those values' steps."""
    off, total = 0, 0
    for name, value in got.items():
        a, b = value.detach().float(), want[name].float()
        if not adam8:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                       atol=PARAM_TOL, err_msg=name)
            continue
        diff = (a - b).abs()
        off += int((diff > PARAM_TOL + rtol * b.abs()).sum())
        total += a.numel()
        assert float(diff.max()) <= 1e-3 * STEPS, name
    assert off <= 1e-3 * total, f"{off} of {total} values differ"


# ------------------------------------------------------------ AGD

AGD_CASES = {
    "defaults": dict(learning_rate=1e-3),
    "amsgrad_clip": dict(learning_rate=1e-3, amsgrad=True, clip=0.5),
    "decoupled_wd": dict(learning_rate=1e-3, weight_decay=0.1),
    "coupled_wd": dict(learning_rate=1e-3, weight_decay=0.1,
                       weight_decouple=False),
    "fixed_decay": dict(learning_rate=1e-3, weight_decay=1e-3,
                        fixed_decay=True),
}


@pytest.mark.parametrize("case", sorted(AGD_CASES))
def test_agd_matches_jax(case):
    kw = AGD_CASES[case]
    j_losses, j_params, _ = jax_run(jax_agd(**kw))
    t_losses, t_params, _ = port_run(agd(**kw))
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert_params_close(t_params, j_params)


def test_agd_rejects_bad_hyperparameters():
    with pytest.raises(ValueError, match="learning rate"):
        agd(0.0)
    with pytest.raises(ValueError, match="betas"):
        agd(1e-3, b1=1.0)([torch.zeros(2)])


# ------------------------------------------------------------ bf16 masters


def fed_grads(steps=STEPS, seed=3):
    """Seeded bf16 gradients in the params' shapes: the JAX tree's and
    the same values by port name, one pair a step."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        tree = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(
                jnp.bfloat16), jax_tree("bfloat16"))
        out.append((jax.tree_util.tree_map(jnp.asarray, tree),
                    params_from_flax(tree)))
    return out


@pytest.mark.parametrize("inner", ["adamw", "adam8bit"])
def test_bf16_master_weights_matches_jax(inner):
    """bf16 params, fp32 masters, the same bf16 gradients on both sides:
    the masters follow JAX's, and the params JAX's ``p + (bf16(master) -
    p)``."""
    j_tx = jax_bf16(optax.adamw(1e-3) if inner == "adamw"
                    else jax_adam8bit(1e-3))
    t_tx = bf16_master_weights(adamw(1e-3) if inner == "adamw"
                               else adam8bit(1e-3))
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree("bfloat16"))
    state = j_tx.init(params)
    model = port_model("bfloat16")
    named = dict(model.named_parameters())
    opt = t_tx(named.items())
    @jax.jit
    def update(grads, state, params):
        updates, state = j_tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for j_grads, t_grads in fed_grads():
        params, state = update(j_grads, state, params)
        opt.update_and_apply([t_grads[n] for n in named],
                             list(named.values()))
    as_port = lambda tree: params_from_flax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree))
    adam8 = inner == "adam8bit"
    assert_params_close(opt.master, as_port(state.master), adam8=adam8)
    assert_params_close(named, as_port(params), rtol=BF16_ULP, adam8=adam8)
    assert all(p.dtype == torch.bfloat16 for p in named.values())


def test_bf16_master_weights_trains_a_model():
    """Through ``auto_accelerate``: bf16 params stay bf16, the masters
    fp32, and the loss falls."""
    batch = torch.from_numpy(batches(1)[0]).long()
    res = auto_accelerate(port_model("bfloat16"),
                          bf16_master_weights(adamw(1e-3)), batch,
                          token_loss, spec=ParallelSpec(), device="cpu")
    state, losses = res.state, []
    for _ in range(4):  # one batch: the loss must fall
        state, m = res.train_step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.bfloat16 for p in res.module.parameters())
    assert all(m.dtype == torch.float32
               for m in res.state["opt"].master.values())


def test_bf16_tiny_updates_accumulate():
    """An update below half a bf16 ulp leaves the param where it is and
    moves the master, so repeated ones add up (JAX's test_optim twin)."""
    w = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    opt = bf16_master_weights(
        functools.partial(torch.optim.SGD, lr=1e-4))([("w", w)])
    for _ in range(100):
        opt.update_and_apply([torch.ones(4, dtype=torch.bfloat16)], [w])
    assert float(opt.master["w"][0]) == pytest.approx(1 - 100 * 1e-4,
                                                      rel=1e-5)
    assert float(w.detach()[0]) < 1.0  # 0.99 rounds away from 1 in bf16


# ------------------------------------------------------------ offload

OFFLOAD_OPTS = {
    "adamw": (lambda: optax.adamw(1e-3), lambda: adamw(1e-3), "float32"),
    "adam8bit": (lambda: jax_adam8bit(1e-3), lambda: adam8bit(1e-3),
                 "float32"),
    "bf16_adamw": (lambda: jax_bf16(optax.adamw(1e-3)),
                   lambda: bf16_master_weights(adamw(1e-3)), "bfloat16"),
    "bf16_adam8bit": (lambda: jax_bf16(jax_adam8bit(1e-3)),
                      lambda: bf16_master_weights(adam8bit(1e-3)),
                      "bfloat16"),
}


def test_offloadable_is_jax_rule():
    assert MIN_OFFLOAD_ELEMS == 4096
    assert offloadable((4096,)) and offloadable((2, 32, 96))
    assert not offloadable((4095,)) and not offloadable(())
    assert not offloadable((2, 32))


@pytest.mark.parametrize("name", sorted(OFFLOAD_OPTS))
def test_offload_moves_the_leaves_jax_moves(name):
    """The leaves the port keeps in host memory are those JAX's
    ``offload_shardings`` puts in ``pinned_host``, by keystr path: the
    big moments and masters, and the 8-bit Adam's int8 moments; not the
    step counts, bias moments or quantization scales."""
    j_tx, t_tx, dtype = OFFLOAD_OPTS[name]
    res = jax_accelerate(
        jgpt.GPT(jax_cfg(getattr(jnp, dtype))), j_tx(),
        jnp.asarray(batches(1)[0]),
        lambda m, p, b: jgpt.loss_fn(m.apply({"params": p}, b), b),
        spec=JaxSpec(), offload_optimizer=True)
    want = {"['opt']" + jax.tree_util.keystr(path)
            for path, x in jax.tree_util.tree_flatten_with_path(
                res.state["opt"])[0]
            if x.sharding.memory_kind == "pinned_host"}
    assert want
    _, _, tres = port_run(t_tx(), dtype, steps=0, offload_optimizer=True)
    opt = tres.state["opt"]
    assert isinstance(opt, OffloadOptimizer)
    moved = {id(t) for t in opt.moved}
    got = set()
    for leaf in train_state_leaves(tres.state):
        hits = [id(m) in moved for m in leaf.members]
        assert all(hits) or not any(hits), leaf.path
        if leaf.members and all(hits):
            got.add(leaf.path)
    assert got == want


@pytest.mark.parametrize("name", ["adamw", "adam8bit", "bf16_adamw"])
def test_offload_matches_jax_and_on_device(name):
    """Offloaded, the port trains bit for bit as without offload and,
    with fp32 params, as JAX's ``offload(inner)`` does (bf16 params: the
    module docstring); between steps the moved leaves are separate host
    tensors and the rest of the state stays put."""
    j_tx, t_tx, dtype = OFFLOAD_OPTS[name]
    base_losses, base_params, _ = port_run(t_tx(), dtype)
    losses, params, res = port_run(offload(t_tx()), dtype)
    assert losses == base_losses
    assert all(torch.equal(params[n], base_params[n]) for n in params)
    if dtype == "float32":
        j_losses, j_params, _ = jax_run(jax_offload(j_tx()), dtype)
        np.testing.assert_allclose(losses, j_losses, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        assert_params_close(params, j_params)
    opt = res.state["opt"]
    assert opt.moved and all(t.device.type == "cpu" for t in opt.moved)
    assert opt.nbytes == sum(t.numel() * t.element_size() for t in opt.moved)
    live = {id(p) for p in res.module.parameters()}
    assert not live & {id(t) for t in opt.moved}
    # Each step moves the state in and out once (no device ms on the CPU),
    # in remat's HostPool's terms.
    assert opt.take_copy_stats() == {
        "out_bytes": STEPS * opt.nbytes, "out_ms": 0.0,
        "in_bytes": STEPS * opt.nbytes, "in_ms": 0.0}


def test_offload_needs_a_jax_state_layout():
    """``offload`` moves the leaves of the JAX state's layout, so an inner
    optimizer without one (AGD) raises when bound, and nothing is moved
    quietly by another rule."""
    with pytest.raises(TypeError, match="no JAX train-state layout"):
        port_run(offload(agd(1e-3)), steps=0)


@pytest.mark.parametrize("name", ["adamw", "bf16_adamw"])
def test_offload_chunks_update_as_one(name, monkeypatch):
    """A per-parameter inner optimizer is updated a chunk of parameters
    at a time (several chunks here), bit for bit as in one piece."""
    # The package's ``offload`` is the function; the module by its name.
    offload_mod = importlib.import_module("dlrover_tpu_torch.optim.offload")
    _, t_tx, dtype = OFFLOAD_OPTS[name]
    base_losses, base_params, _ = port_run(t_tx(), dtype)
    monkeypatch.setattr(offload_mod, "CHUNK_BYTES", 16 << 10)
    losses, params, res = port_run(offload(t_tx()), dtype)
    assert len(res.state["opt"]._chunks) > 2
    assert losses == base_losses
    assert all(torch.equal(params[n], base_params[n]) for n in params)


def test_offload_through_trainer_kwargs():
    """``Trainer(offload_optimizer=True)`` reaches ``auto_accelerate``."""
    t = Trainer(port_model(), adamw(1e-3), token_loss, batches(1)[0],
                spec=ParallelSpec(), device="cpu", offload_optimizer=True)
    assert isinstance(t.state["opt"], OffloadOptimizer)
    out = t.fit(iter(batches()), steps=STEPS)
    assert out["step"] == STEPS


@pytest.mark.parametrize("kwargs,error", [
    (dict(precision="int8"), NotImplementedError),
    (dict(devices=[]), ValueError),
    (dict(registry=ShardingRegistry()), None),
    (dict(precision="fp8"), ValueError),
    (dict(rng=0), TypeError),
])
def test_other_accel_kwargs_raise(kwargs, error, monkeypatch):
    """The keyword arguments ``Trainer`` passes on to ``auto_accelerate``:
    those of later slices raise, naming them; ``registry=`` reaches it
    (a model that names its own axes trains as without it); ``devices``
    of another length than the world's raises as JAX's "needs N
    devices, have n"."""
    if error is not None:
        with pytest.raises(error, match="ROADMAP|precision|rng|devices"):
            Trainer(port_model(), adamw(1e-3), token_loss, batches(1)[0],
                    spec=ParallelSpec(), device="cpu", **kwargs)
        return
    import dlrover_tpu_torch.accel as accel

    seen = []
    real = accel.auto_accelerate

    def spy(*args, **kw):
        seen.append(kw.get("registry"))
        return real(*args, **kw)

    monkeypatch.setattr(accel, "auto_accelerate", spy)
    t = Trainer(port_model(), adamw(1e-3), token_loss, batches(1)[0],
                spec=ParallelSpec(), device="cpu", **kwargs)
    assert seen == [kwargs["registry"]]
    assert t.fit(iter(batches()), steps=STEPS)["step"] == STEPS


@pytest.mark.parametrize("name", ["adamw", "adam8bit", "bf16_adamw"])
def test_offloaded_checkpoint_restores_bit_for_bit(name, tmp_path,
                                                   monkeypatch):
    """A Trainer with its optimizer offloaded persists step 2; a fresh
    one restores it bit for bit into its own tensors, the moved leaves
    still host tensors, and both then take the same step (one thread, so
    the CPU math repeats bit for bit)."""
    _, t_tx, dtype = OFFLOAD_OPTS[name]
    job = f"offload-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def trainer(seed):
        model = port_model(dtype)
        if seed:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        return Trainer(model, t_tx(), token_loss, batches(1)[0],
                       spec=ParallelSpec(), device="cpu",
                       checkpoint_dir=str(tmp_path), persist_every=2,
                       offload_optimizer=True)

    def state_bytes(t):
        return {leaf.path: b"".join(m.detach().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes() for m in leaf.members)
            if leaf.members else leaf.value
            for leaf in train_state_leaves(t.state)}

    data = batches(4)
    a = trainer(0)
    try:
        a.fit(iter(data[:2]), steps=2)
        b = trainer(1)
        moved = list(b.state["opt"].moved)
        assert state_bytes(b) != state_bytes(a)
        assert b.restore() == 2
        assert state_bytes(b) == state_bytes(a)
        assert all(x is y for x, y in zip(b.state["opt"].moved, moved))
        assert all(t.device.type == "cpu" for t in moved)
        losses = []
        for t in (a, b):
            state, m = t.train_step(t.state, torch.from_numpy(data[2]).long())
            losses.append(float(m["loss"]))
        assert losses[0] == losses[1]
        b.close()
    finally:
        a.close()
        torch.set_num_threads(threads)
        for path in glob.glob(f"/dev/shm/ckpt_{job}_*"):
            os.unlink(path)


@pytest.mark.parametrize("inner", ["adamw", "adam8bit"])
def test_bf16_state_layout_matches_jax(inner):
    """bf16_master_weights' state flattens to the JAX engine's leaves:
    ``['opt'].master[...]`` then the inner state under ``['opt'].inner``
    (offload keeps its inner's layout)."""
    from dlrover_tpu.train.checkpoint import engine as jax_engine

    j_tx = jax_bf16(optax.adamw(1e-3) if inner == "adamw"
                    else jax_adam8bit(1e-3))
    t_tx = bf16_master_weights(adamw(1e-3) if inner == "adamw"
                               else adam8bit(1e-3))
    res = jax_accelerate(
        jgpt.GPT(jax_cfg(jnp.bfloat16)), j_tx, jnp.asarray(batches(1)[0]),
        lambda m, p, b: jgpt.loss_fn(m.apply({"params": p}, b), b),
        spec=JaxSpec())
    arrays, _ = jax_engine._flatten_state(res.state)
    want = [(p, str(np.asarray(x).dtype), tuple(np.shape(x)))
            for p, x in arrays]
    _, _, tres = port_run(offload(t_tx), "bfloat16", steps=0)
    leaves, _ = port_engine._flatten_state(tres.state)
    got = [(leaf.path, port_engine.DTYPE_NAMES[leaf.dtype], leaf.shape)
           for leaf in leaves]
    assert got == want


# ------------------------------------------------------------ WSAM

WSAM_CASES = {
    "decoupled": dict(decouple=True),
    "folded": dict(decouple=False),
    "adaptive": dict(adaptive=True, rho=0.5),
}


@pytest.mark.parametrize("case", sorted(WSAM_CASES))
def test_wsam_matches_jax(case):
    """Both passes, the returned first-pass loss and the base update
    (AdamW) as JAX's ``WeightedSAM.step``."""
    kw = dict(rho=0.05, gamma=0.9, sharpness_lr=1e-3)
    kw.update(WSAM_CASES[case])
    model = jgpt.GPT(jax_cfg())
    j_opt = JaxWSAM(optax.adamw(1e-3), **kw)
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree())
    @jax.jit
    def step(params, state, t):
        return j_opt.step(
            lambda p: jgpt.loss_fn(model.apply({"params": p}, t), t),
            params, state)

    state, j_losses = j_opt.init(params), []
    for toks in batches():
        params, state, lv = step(params, state, jnp.asarray(toks))
        j_losses.append(float(lv))
    j_params = params_from_flax(jax.tree_util.tree_map(np.asarray, params))

    port = port_model()
    t_opt = WeightedSAM(adamw(1e-3), **kw).init(port.named_parameters())
    t_losses = []
    for toks in batches():
        t = torch.from_numpy(toks).long()
        t_losses.append(float(t_opt.step(lambda: loss_fn(port(t), t))))
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert_params_close({n: p.detach() for n, p in
                         port.named_parameters()}, j_params)
    assert all(p.grad is None for p in port.parameters())


def test_wsam_rho_zero_equals_base():
    """rho 0 perturbs nothing: WSAM is its base optimizer (the decoupled
    sharpness step is along g_sharp - g = 0)."""
    base = port_model()
    res = auto_accelerate(base, adamw(1e-3), batches(1)[0], token_loss,
                          spec=ParallelSpec(), device="cpu")
    port = port_model()
    wsam = WeightedSAM(adamw(1e-3), rho=0.0).init(
        port.named_parameters())
    for toks in batches():
        t = torch.from_numpy(toks).long()
        res.train_step(res.state, t)
        wsam.step(lambda: loss_fn(port(t), t))
    for (n, p), q in zip(port.named_parameters(), base.parameters()):
        assert torch.equal(p, q), n


def test_wsam_needs_init_and_valid_rho():
    with pytest.raises(ValueError, match="rho"):
        WeightedSAM(adamw(1e-3), rho=-1.0)
    with pytest.raises(RuntimeError, match="init"):
        WeightedSAM(adamw(1e-3)).step(lambda: torch.zeros(()))
