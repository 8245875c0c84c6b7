"""The port's mesh layer against the JAX package's, in one process.

The mesh's axis order and sizes, the logical-axis rules (with the vocab
guard), each parameter's logical axes and the tensor axis's placements
are held to ``dlrover_tpu/accel``'s; ``Layout`` is held to DTensor's
and FSDP2's chunking and to JAX's contiguous columns of the fused qkv;
the specs and head counts this slice refuses raise. Each axis's branch
then runs on a one-rank gloo mesh that has the axis, as the card runs
it (``chip_smoke.py``), and its losses equal the one-device path's bit
for bit. The multi-process training and checkpoints are in
``tests/test_torch_parallel.py``.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dlrover_tpu.accel import mesh as jmesh
from dlrover_tpu.accel import sharding as jsharding
from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch.accel import accelerate, mesh, sharding
from dlrover_tpu_torch.accel.accelerate import ParallelSpec, auto_accelerate
from dlrover_tpu_torch.models.convert import jax_leaves
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
from dlrover_tpu_torch.optim import adam8bit, adamw


class FakeMesh:
    """What ``Layout`` reads of a DeviceMesh, at a chosen coordinate."""

    def __init__(self, sizes: dict, coord):
        self.mesh_dim_names = tuple(sizes)
        self.mesh = torch.zeros(tuple(sizes.values()))
        self.ndim = len(sizes)
        self._coord = list(coord)

    def get_coordinate(self):
        return self._coord


# ------------------------------------------------------ mesh and rules


@pytest.mark.parametrize("axes,n", [
    ([("data", -1), ("tensor", 2)], 8),
    ([("tensor", 2), ("data", 2), ("fsdp", 2)], 8),
    ([("fsdp", 4)], 4),
    ([("data", 1), ("fsdp", 1)], 1),
])
def test_mesh_config_matches_jax(axes, n):
    got = mesh.MeshConfig(axes).resolved(n)
    assert got == jmesh.MeshConfig(axes).resolved(n)
    assert mesh._canonical_order(got) == jmesh._canonical_order(got)
    assert mesh.AXIS_ORDER == jmesh.AXIS_ORDER


@pytest.mark.parametrize("axes,n", [([("data", 3)], 8),
                                    ([("data", -1), ("fsdp", -1)], 8)])
def test_mesh_config_bad_sizes_raise(axes, n):
    with pytest.raises(ValueError):
        mesh.MeshConfig(axes).resolved(n)


@pytest.mark.parametrize("degrees", [
    dict(data=2), dict(fsdp=2), dict(tensor=2), dict(data=2, fsdp=2),
    dict(data=2, tensor=2), dict(tensor=2, vocab_size=50257),
    dict(tensor=2, vocab_size=32000), dict(data=2, zero=True),
    dict(data=2, fsdp=2, tensor=2, seq=2, expert=2, pipe=2),
])
def test_logical_rules_match_jax(degrees):
    assert sharding.logical_rules(**degrees) == \
        jsharding.logical_rules(**degrees)


def _jax_names(model, tokens):
    abstract = jax.eval_shape(lambda r: model.init(r, tokens),
                              jax.random.PRNGKey(0))
    specs = nn.get_partition_spec(abstract)["params"]
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(k.key for k in path): tuple(spec)
            for path, spec in flat}


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_logical_axes_match_jax(family):
    """Every port parameter carries the logical axes the JAX model
    annotates on the same leaf (unscanned, so a leaf is one layer's)."""
    tokens = jnp.zeros((1, 8), jnp.int32)
    if family == "gpt":
        jm = jgpt.GPT(dataclasses.replace(jgpt.GPTConfig.tiny(),
                                          scan_layers=False))
        port = GPT(GPTConfig.tiny(), device="cpu")
    else:
        jm = jllama.Llama(dataclasses.replace(jllama.LlamaConfig.tiny(),
                                              scan_layers=False))
        port = Llama(LlamaConfig.tiny(), device="cpu")
    want = _jax_names(jm, tokens)
    axes = port.logical_axes()
    leaves = jax_leaves(((n, tuple(p.shape))
                         for n, p in port.named_parameters()), stacked=False)
    assert set(axes) == {n for n, _ in port.named_parameters()}
    assert set(leaves) == set(want)
    for path, leaf in leaves.items():
        (name,) = leaf.names
        assert axes[name] == want[path], (name, path)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_tensor_placements_follow_the_rules(family):
    """Under tensor=2 the Dense kernels the rules map to the tensor axis
    are column-parallel (output dim: heads, mlp, vocab) or row-parallel
    (input dim), as the JAX rules place them."""
    port = (GPT(GPTConfig.tiny(), device="cpu") if family == "gpt"
            else Llama(LlamaConfig.tiny(), device="cpu"))
    rules = ParallelSpec(tensor=2).rules(vocab_size=256)
    jrules = jsharding.logical_rules(tensor=2, vocab_size=256)
    got = {n: sharding.mesh_dims(a, rules).get("tensor")
           for n, a in port.logical_axes().items()}
    for name, axes in port.logical_axes().items():
        spec = nn.logical_to_mesh_axes(axes, jrules)
        want = next((d for d, a in enumerate(spec) if a in
                     ("tensor", ("tensor",))), None)
        assert got[name] == want, name
    kind = {"qkv": 1, "up": 1, "proj": 0, "down": 0, "q_proj": 1,
            "k_proj": 1, "v_proj": 1, "gate_proj": 1, "up_proj": 1,
            "o_proj": 0, "down_proj": 0, "lm_head": 1}
    for name, dim in got.items():
        if name.endswith(".kernel") and name.split(".")[-2] in kind:
            assert dim == kind[name.split(".")[-2]], name
    assert sharding.mesh_dims(("vocab", "embed"), ParallelSpec(
        tensor=2).rules(vocab_size=50257)) == {}  # GPT-2's vocab: replicated


# ------------------------------------------------------ layouts


@pytest.mark.parametrize("size,n", [(5, 2), (3, 4), (8, 2), (50257, 2)])
def test_fsdp_chunks_are_torch_chunk(size, n):
    """An fsdp shard is ``torch.chunk``'s piece, as FSDP2 and DTensor
    split (the last ranks' pieces may be short or empty)."""
    full = torch.arange(size * 3).reshape(size, 3)
    pieces = list(torch.chunk(full, n, dim=0))
    pieces += [full[:0]] * (n - len(pieces))
    for c in range(n):
        lay = sharding.Layout.of(FakeMesh({"fsdp": n}, [c]), {"fsdp": 0})
        assert lay.local_shape((size, 3)) == tuple(pieces[c].shape)
        assert torch.equal(sharding.local_from_full(full, lay), pieces[c])
        assert lay.replica() == 0


def test_fused_qkv_regions_are_each_ranks_heads():
    """The qkv kernel [d, 3d] over tensor=2: a rank's local columns are
    its heads of q, of k and of v (three regions of JAX's contiguous
    columns); the two ranks' blocks tile the leaf."""
    d, t = 8, 2
    full = torch.arange(d * 3 * d).reshape(d, 3 * d)
    seen = torch.zeros_like(full)
    for c in range(t):
        lay = sharding.Layout.of(FakeMesh({"data": 2, "tensor": t}, [1, c]),
                                 {"tensor": 1}, fused=3)
        local = sharding.local_from_full(full, lay)
        w = d // t
        want = torch.cat([full[:, j * d + c * w:j * d + (c + 1) * w]
                          for j in range(3)], dim=1)
        assert torch.equal(local, want)
        got = sharding.blocks(local, lay, (d, 3 * d))
        assert [r for r, _ in got] == [
            ((0, d), (j * d + c * w, j * d + (c + 1) * w)) for j in range(3)]
        for region, view in got:
            (a, b), (e, f) = region
            seen[a:b, e:f] += view
        # Replica 1 of data: its blocks are another rank's to persist.
        assert lay.replica() == 1
    assert torch.equal(seen, full)


def test_replica_index_counts_unsharded_axes():
    sizes = {"data": 2, "fsdp": 2}
    for coord in ([0, 0], [0, 1], [1, 0], [1, 1]):
        m = FakeMesh(sizes, coord)
        assert sharding.Layout.of(m, {"fsdp": 0}).replica() == coord[0]
        assert sharding.Layout.replicated(m).replica() == \
            coord[0] * 2 + coord[1]


# ------------------------------------------------------ what raises


@pytest.mark.parametrize("spec,match", [
    # ZeRO-1 over data beside any axis trains (tests/test_torch_zero.py);
    # a composition it joins is refused as without it.
    (ParallelSpec(data=2, seq=2, fsdp=2, zero=True), "item 6"),
    (ParallelSpec(collectives=(("data", "lat"),)), "collectives"),
    # seq, expert and pipe degrees place a module
    # (tests/test_torch_seq_expert.py, tests/test_torch_pipeline.py);
    # together, or with fsdp or tensor, they still raise.
    (ParallelSpec(seq=2, expert=2), "item 6"),
    (ParallelSpec(expert=2, fsdp=2), "item 6"),
    (ParallelSpec(pipe=2, tensor=2), "item 6"),
])
def test_later_specs_raise_naming_their_slice(spec, match):
    with pytest.raises(NotImplementedError, match=match):
        auto_accelerate(GPT(GPTConfig.tiny(), device="cpu"), adamw(1e-3),
                        np.zeros((2, 8), np.int64), None, spec=spec,
                        device="cpu")


@pytest.mark.parametrize("axis", ["seq", "expert", "pipe"])
def test_zero_beside_seq_expert_or_pipe_passes_the_spec_check(axis):
    """ZeRO-1 beside seq, expert or pipe is placed: the spec check lets
    it through (on a model that carries the axis), and a world of one
    refuses only its size."""
    from dlrover_tpu_torch.accel.accelerate import _check_spec

    carries = {"stage": True, "expert": True}
    spec = ParallelSpec(data=2, zero=True, **{axis: 2})
    with pytest.raises(ValueError, match="world of 4"):
        _check_spec(spec, carries)


def test_auto_over_several_processes_raises(monkeypatch):
    """``"auto"`` over several processes searches a plain module too (its
    profile from its parameter count, as JAX's; tests/test_torch_search.py
    trains one on a world of 4): the search ranks a spec of the world's
    2 processes, and only joining the world, which this process is not
    in, raises."""
    from dlrover_tpu_torch.accel import search

    monkeypatch.setenv("WORLD_SIZE", "2")
    for name in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    ranked = []
    real = search.search_spec

    def spy(*args, **kwargs):
        ranked.extend(real(*args, **kwargs))
        return ranked

    monkeypatch.setattr(search, "search_spec", spy)
    plain = torch.nn.Sequential(torch.nn.Linear(8, 8))
    with pytest.raises(RuntimeError, match="torchrun"):
        auto_accelerate(plain, adamw(1e-3), np.zeros((2, 8), np.int64), None,
                        device="cpu")
    assert ranked and all(sp.total == 2 for sp, _ in ranked)


def test_spec_must_match_the_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="world of 4"):
        auto_accelerate(GPT(GPTConfig.tiny(), device="cpu"), adamw(1e-3),
                        np.zeros((4, 8), np.int64), None,
                        spec=ParallelSpec(fsdp=4), device="cpu")


def test_bad_collective_strategy_raises_as_in_jax():
    with pytest.raises(ValueError, match="unknown collective"):
        ParallelSpec(collectives=(("data", "ring"),))
    assert ParallelSpec(collectives={"data": "bw"}).collectives == \
        (("data", "bw"),)


@pytest.mark.parametrize("model", [
    lambda: GPT(dataclasses.replace(GPTConfig.tiny(), num_heads=25,
                                    d_model=50), device="cpu"),
    lambda: Llama(dataclasses.replace(LlamaConfig.tiny(), num_kv_heads=1),
                  device="cpu"),
], ids=["gpt-25-heads", "llama-1-kv-head"])
def test_indivisible_heads_raise(model):
    m = model()
    with pytest.raises(ValueError, match="does not divide"):
        accelerate.tensor_parallel(m, FakeMesh({"tensor": 2}, [0]),
                                   ParallelSpec(tensor=2).rules())


# ------------------------------------------------------ a one-rank mesh


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    """A gloo process group of one rank, as the card's NCCL one; it meets
    at a file, so no port is picked."""
    if dist.is_initialized():
        pytest.fail("a process group is already up in this process")
    rdzv = tmp_path_factory.mktemp("world-of-one") / "rdzv"
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _losses(res, batches):
    out = []
    for b in batches:
        _, m = res.train_step(res.state, torch.from_numpy(
            res.local_batch(b)))
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("axis,family", [
    ("fsdp", "gpt"), ("data", "gpt"), ("tensor", "llama"),
    ("tensor", "gpt"), ("fsdp", "llama"), ("fsdp+tensor", "llama"),
    ("data+fsdp+tensor", "gpt"),
])
def test_one_rank_mesh_equals_one_device(world_of_one, axis, family):
    """Each axis's branch on a mesh of one rank (a collective is a copy,
    the division is by 1) gives the one-device path's losses bit for
    bit, with remat "dots" and the fused 8-bit Adam, and its parameters
    too. An axis of size 1 takes its branch: under tensor the
    embedding's lookup is vocab-parallel; fsdp and tensor together are
    FSDP2 over the tensor-parallel DTensors."""
    torch.manual_seed(0)
    if family == "gpt":
        cfg = dataclasses.replace(GPTConfig.tiny(), remat=True,
                                  remat_policy="dots")
        make = lambda: GPT(cfg, device="cpu")  # noqa: E731
    else:
        cfg = dataclasses.replace(LlamaConfig.tiny(), remat=True,
                                  remat_policy="dots")
        make = lambda: Llama(cfg, device="cpu")  # noqa: E731
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 256, (4, 16)) for _ in range(3)]
    loss = lambda m, p, b: loss_fn(m(b), b)  # noqa: E731
    one = auto_accelerate(make(), adam8bit(1e-2), batches[0], loss,
                          spec=ParallelSpec(), device="cpu")
    m = mesh.create_mesh([(a, 1) for a in axis.split("+")],
                         torch.device("cpu"))
    res = accelerate.accelerate_on_mesh(make(), adam8bit(1e-2), batches[0],
                                        loss, m, device="cpu")
    assert res.mesh is m and res.batch_rows == ((0, 4), 4)
    assert (res.module.vocab_mesh is not None) == ("tensor" in axis)
    assert _losses(res, batches) == _losses(one, batches)
    for name, p in res.state["params"].items():
        assert torch.equal(sharding.local(p), one.state["params"][name]), name
