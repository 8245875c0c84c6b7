"""The port's strategy search against ``dlrover_tpu/accel/search.py``.

The same profiles and the same constants go to both packages: the JAX
package's own (v5e: 197 TFLOP/s, ICI 90 GB/s, DCN 2.5 GB/s, HBM 819
GB/s, derate 0.42, latencies 5 / 100 us, 16 GB) and the port's H100
defaults (989 TFLOP/s, NVLink 450 GB/s, 50 GB/s between hosts, HBM 3.35
TB/s, the calibrated derate, 10 / 30 us, 80 GB). The JAX constants that
are module globals (``_MFU_DERATE``, ``_COLL_LAT``, ``_DCN_LAT``, and
``_HBM_BW`` through ``estimate``'s default) are set with ``monkeypatch``
on the imported JAX module inside the test. For every row of
``tests/test_search.py``'s enumeration, choice, zero and hierarchy
cases: ``enumerate_specs`` gives JAX's set, every ``CostEstimate``
field JAX's within 1e-9 relative, ``search_spec`` JAX's top-k in order.
The exact per-device state bytes (the port's from a model built on the
meta device, JAX's from ``jax.eval_shape``) agree to the byte for GPT
and LLaMA tiny under AdamW, fp32 masters and the 8-bit Adam, pipelined
or not, over every candidate of 8 devices. ``reconfigure_module`` makes
JAX's config and carries the weights. ``auto_accelerate("auto")`` then
runs on a world of 4 gloo ranks (a file rendezvous; this file is the
worker: ``python tests/test_torch_search.py <inputs>``): it chooses what
JAX's ``search_spec`` chooses for 4 devices, and trains bit for bit as
that spec given explicitly; with ``profile=True`` every rank builds the
same winner and the caller's weights come back unstepped. A plain
module there (``tests/test_torch_registry.py``'s twin of the flax
``PlainLM``, from its init) under ``"auto"`` with ``allow_tensor=True``
ranks as JAX ranks it (its profile from the parameter count, a head
count of the world's size, no names on its state), is planned and
placed, and its losses are JAX's ``auto_accelerate`` of the flax model
under the chosen spec within 2e-5 (``tests/test_tp_planner.py``'s
tolerance). ``devices=`` (one device a rank: four CPU devices) searches
over ``len(devices)`` as JAX's does, ranks as JAX's ``search_spec`` of
4 devices, and trains as the spec it chooses; a list of another length
than the world's, or a ``device`` that is not the rank's entry, raises
as JAX's "needs N devices, have n" does. The search admits the pipelined
candidates of the ``update_and_apply`` optimizers (the 8-bit Adam, fp32
masters), which the port now places on pipe ranks.
"""

import contextlib
import dataclasses
import functools
import logging
import math
import os
import pickle
import sys
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.accel import search
from dlrover_tpu_torch.accel.accelerate import ParallelSpec, auto_accelerate
from dlrover_tpu_torch.accel.registry import ShardingRegistry
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
from dlrover_tpu_torch.optim import adam8bit, adamw, bf16_master_weights

FIELDS = ("data", "fsdp", "tensor", "seq", "expert", "pipe", "zero")
COST_FIELDS = ("state_bytes", "grad_bytes", "act_bytes", "compute_s",
               "comm_overlap_s", "comm_critical_s", "bubble", "hbm_s",
               "step_s", "total_bytes")
REL = 1e-9
# Each set of constants: estimate's keyword arguments, the JAX module
# globals they stand for, and the HBM the search is given.
CONSTANTS = {
    "jax": dict(peak_flops=197e12, ici_bw=9e10, dcn_bw=2.5e9,
                hbm_bw=8.19e11, mfu_derate=0.42, coll_lat=5e-6,
                dcn_lat=100e-6, hbm=16e9),
    "h100": dict(peak_flops=search.PEAK_FLOPS, ici_bw=search.ICI_BW,
                 dcn_bw=search.DCN_BW, hbm_bw=search.HBM_BW,
                 mfu_derate=search.MFU_DERATE, coll_lat=search.COLL_LAT,
                 dcn_lat=search.DCN_LAT, hbm=search.HBM_BYTES),
}

# tests/test_search.py's configurations.
GPT_CFGS = {
    "tiny": dict(vocab_size=256, max_seq_len=64, num_layers=2, num_heads=2,
                 d_model=32),
    "families": dict(vocab_size=50264, max_seq_len=2048, num_layers=8,
                     num_heads=8, d_model=512),
    "xl": dict(vocab_size=50257, max_seq_len=1024, num_layers=48,
               num_heads=25, d_model=1600, remat=True),
    "moe": dict(vocab_size=50264, max_seq_len=1024, num_layers=16,
                num_heads=16, d_model=2048, num_experts=8, remat=True),
    "long": dict(vocab_size=50264, max_seq_len=32768, num_layers=24,
                 num_heads=16, d_model=2048, remat=True),
    "big": dict(vocab_size=50264, max_seq_len=4096, num_layers=48,
                num_heads=32, d_model=8192, remat=True),
    "floor": dict(vocab_size=50264, max_seq_len=2048, num_layers=32,
                  num_heads=32, d_model=4096, remat=True),
}
LLAMA_CFG = dict(vocab_size=32000, max_seq_len=2048, num_layers=18,
                 num_heads=16, num_kv_heads=8, d_model=2048, remat=True,
                 remat_policy="dots")
# (case, family, config, bf16 params, devices, batch, estimate's extras)
CASES = [
    ("families", "gpt", "families", False, 8, 8, {}),
    ("gating", "params", None, False, 8, 8, {}),
    ("batch-divisibility", "gpt", "tiny", False, 8, 2, {}),
    ("small-dense", "gpt", "tiny", False, 8, 8, {}),
    ("too-big-dense", "gpt", "xl", False, 8, 8, {}),
    ("moe", "gpt", "moe", False, 8, 8, {}),
    ("long-context", "gpt", "long", False, 8, 1, {}),
    ("pipe-over-dcn", "gpt", "big", False, 8, 32, {"ici_bw": 2e9}),
    ("fast-ici", "gpt", "big", False, 8, 32, {}),
    ("weight-floor", "gpt", "floor", False, 8, 8, {}),
    ("zero-xl-bf16", "gpt", "xl", True, 8, 8, {}),
    ("hier-xl", "gpt", "xl", False, 16, 16, {"devices_per_host": 8}),
    ("hier-pp", "gpt", "floor", False, 16, 16, {"devices_per_host": 8}),
    ("llama", "llama", "llama", False, 8, 8, {}),
]


def _jax():
    import jax.numpy as jnp

    from dlrover_tpu.accel import accelerate as jaccel
    from dlrover_tpu.accel import search as jsearch
    from dlrover_tpu.models import gpt as jgpt
    from dlrover_tpu.models import llama as jllama

    return jnp, jaccel, jsearch, jgpt, jllama


def profiles(family, name, bf16):
    """(JAX profile, port profile) of a case's model."""
    jnp, _, jsearch, jgpt, jllama = _jax()
    if family == "params":
        return (jsearch.ModelProfile.from_params(1_000_000),
                search.ModelProfile.from_params(1_000_000))
    kw = LLAMA_CFG if family == "llama" else GPT_CFGS[name]
    jcls = jllama.LlamaConfig if family == "llama" else jgpt.GPTConfig
    tcls = LlamaConfig if family == "llama" else GPTConfig
    jkw, tkw = dict(kw), dict(kw)
    if bf16:
        jkw["param_dtype"], tkw["param_dtype"] = jnp.bfloat16, torch.bfloat16
    return (jsearch.ModelProfile.from_config(jcls(**jkw)),
            search.ModelProfile.from_config(tcls(**tkw)))


def spec_key(s):
    return tuple(getattr(s, f) for f in FIELDS)


def same(a: float, b: float) -> bool:
    return a == b or math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def assert_costs_equal(got, want, label):
    for f in COST_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert same(g, w), (label, f, g, w)


def patch_jax(monkeypatch, consts):
    """The JAX module globals set to ``consts``; ``estimate``'s HBM
    bandwidth default through a wrapper ``search_spec`` calls."""
    _, _, jsearch, _, _ = _jax()
    monkeypatch.setattr(jsearch, "_MFU_DERATE", consts["mfu_derate"])
    monkeypatch.setattr(jsearch, "_COLL_LAT", consts["coll_lat"])
    monkeypatch.setattr(jsearch, "_DCN_LAT", consts["dcn_lat"])
    monkeypatch.setattr(jsearch, "estimate", functools.partial(
        jsearch.estimate, hbm_bw=consts["hbm_bw"]))
    return jsearch


@contextlib.contextmanager
def port_log():
    """The records the port's logger (which does not propagate) emits."""
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)


def port_kw(consts, extra):
    kw = {k: v for k, v in consts.items() if k != "hbm"}
    kw.update(extra)
    return kw


# ------------------------------------------------------ profiles, enumeration


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_profile_matches_jax(case):
    _, family, name, bf16, *_ = case
    want, got = profiles(family, name, bf16)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_enumeration_matches_jax(case):
    _, family, name, bf16, n, batch, _ = case
    jprof, prof = profiles(family, name, bf16)
    _, _, jsearch, _, _ = _jax()
    want = [spec_key(s) for s in jsearch.enumerate_specs(jprof, n, batch)]
    got = [spec_key(s) for s in search.enumerate_specs(prof, n, batch)]
    assert got == want
    assert all(s.total == n for s in search.enumerate_specs(prof, n, batch))


# ------------------------------------------------------ the cost model


@pytest.mark.parametrize("consts", sorted(CONSTANTS))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_estimates_match_jax(case, consts, monkeypatch):
    """Every field of every candidate's estimate (the ZeRO variants and
    the hierarchy's DCN axes among them)."""
    _, family, name, bf16, n, batch, extra = case
    c = CONSTANTS[consts]
    jsearch = patch_jax(monkeypatch, c)
    jprof, prof = profiles(family, name, bf16)
    kw = port_kw(c, extra)
    jkw = {k: kw[k] for k in ("peak_flops", "ici_bw", "dcn_bw")}
    jkw.update({k: v for k, v in extra.items() if k not in jkw})
    for spec in search.enumerate_specs(prof, n, batch):
        jspec = _jax()[1].ParallelSpec(
            **{f: getattr(spec, f) for f in FIELDS})
        want = jsearch.estimate(jprof, jspec, batch, c["hbm"], **jkw)
        got = search.estimate(prof, spec, batch, c["hbm"], **kw)
        assert_costs_equal(got, want, spec)
        assert got.fits(c["hbm"]) == want.fits(c["hbm"])


@pytest.mark.parametrize("consts", sorted(CONSTANTS))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_search_matches_jax(case, consts, monkeypatch):
    """``search_spec``'s top 4, in order, with their estimates; under
    JAX's constants tests/test_search.py's choices come out (fsdp for
    GPT-2 xl, expert for the MoE, seq at 32k, pipe over a slow link, no
    host-crossing fsdp on two hosts, ZeRO when replicated Adam does not
    fit)."""
    label, family, name, bf16, n, batch, extra = case
    c = CONSTANTS[consts]
    jsearch = patch_jax(monkeypatch, c)
    jprof, prof = profiles(family, name, bf16)
    kw = port_kw(c, extra)
    jkw = {k: kw[k] for k in ("peak_flops", "ici_bw", "dcn_bw")}
    jkw.update({k: v for k, v in extra.items() if k not in jkw})
    want = jsearch.search_spec(jprof, n, batch, c["hbm"], **jkw)
    got = search.search_spec(prof, n, batch, c["hbm"], **kw)
    assert [spec_key(s) for s, _ in got] == [spec_key(s) for s, _ in want]
    for (s, g), (_, w) in zip(got, want):
        assert_costs_equal(g, w, s)
    if consts != "jax":
        return
    top = got[0][0]
    expect = {"too-big-dense": top.fsdp > 1, "moe": top.expert > 1,
              "long-context": top.seq > 1, "pipe-over-dcn": top.pipe > 1,
              "fast-ici": top.pipe == 1, "small-dense":
              top == ParallelSpec(data=8), "hier-xl": top.fsdp <= 8,
              "zero-xl-bf16": ParallelSpec(data=8, zero=True) in
              [s for s, _ in got] and ParallelSpec(data=8) not in
              [s for s, _ in got]}
    assert expect.get(label, True), (label, top)


def test_zero_variant_fits_where_replicated_does_not():
    """tests/test_zero.py's case: bf16 GPT-2 xl on 8 x 16 GB."""
    _, prof = profiles("gpt", "xl", True)
    rep = search.estimate(prof, ParallelSpec(data=8), 8, 16e9)
    zro = search.estimate(prof, ParallelSpec(data=8, zero=True), 8, 16e9)
    assert not rep.fits(16e9) and zro.fits(16e9)
    assert zro.grad_bytes == rep.grad_bytes
    assert zro.total_bytes < rep.total_bytes


def test_collectives_are_priced_with_the_comms_governor():
    _, prof = profiles("gpt", "tiny", False)
    with pytest.raises(NotImplementedError, match="item 5"):
        search.estimate(prof, ParallelSpec(data=8, collectives=(
            ("data", "lat"),)), 8, 16e9)


# ------------------------------------------------------ exact state bytes


def models(family, bf16=False, **over):
    """(JAX model, port model on the meta device) of a tiny config."""
    jnp, _, _, jgpt, jllama = _jax()
    if family == "gpt":
        jcfg = dataclasses.replace(jgpt.GPTConfig.tiny(), **over)
        tcfg = dataclasses.replace(GPTConfig.tiny(), **over)
        jm, tcls = jgpt.GPT, GPT
    else:
        jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), **over)
        tcfg = dataclasses.replace(LlamaConfig.tiny(), **over)
        jm, tcls = jllama.Llama, Llama
    if bf16:
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16)
    return jm(jcfg), tcls(tcfg, device="meta", generator=torch.Generator())


OPTS = {
    "adamw": (lambda: __import__("optax").adamw(1e-3), lambda: adamw(1e-3),
              False),
    "bf16-adamw": (lambda: _jbf16()(__import__("optax").adamw(1e-3)),
                   lambda: bf16_master_weights(adamw(1e-3)), True),
    "adam8bit": (lambda: _jadam8()(1e-3), lambda: adam8bit(1e-3), True),
}


def _jbf16():
    from dlrover_tpu.optim.bf16 import bf16_master_weights as f

    return f


def _jadam8():
    from dlrover_tpu.optim.low_bit import adam8bit as f

    return f


def jax_abstract(model, opt, rows=8):
    import jax
    import jax.numpy as jnp

    tokens = jnp.zeros((rows, 16), jnp.int32)

    def init_fn(r):
        p = model.init(r, tokens)["params"]
        return {"params": p, "opt": opt.init(p), "step": 0}

    return jax.eval_shape(init_fn, jax.random.PRNGKey(0))


def jax_names(abstract):
    import jax

    flat = jax.tree_util.tree_flatten_with_path(
        abstract, is_leaf=lambda x: hasattr(x, "names"))[0]
    return {jax.tree_util.keystr(p): (tuple(leaf.names)
                                      if hasattr(leaf, "names") else None)
            for p, leaf in flat}


@pytest.mark.parametrize("schedule", ["none", "gpipe", "circular"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_abstract_leaves_match_jax(family, schedule):
    """Every leaf's path, shape and logical names, stages included."""
    over = {"none": {}, "gpipe": dict(pipeline_stages=2,
                                      pipeline_microbatches=2),
            "circular": dict(num_layers=4, pipeline_stages=2,
                             pipeline_repeats=2, pipeline_microbatches=2)}
    jm, tm = models(family, **over[schedule])
    want = jax_names(jax_abstract(jm, __import__("optax").adamw(1e-3)))
    got = search.abstract_state(tm, adamw(1e-3))
    assert [leaf.path for leaf in got] == list(want)
    for leaf in got:
        assert leaf.names == want[leaf.path], leaf.path


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_state_bytes_match_jax_to_the_byte(family, opt):
    """Over every candidate of 8 devices (batch 8), ZeRO's included, each
    pipe candidate on its reconfigured model."""
    j_opt, t_opt, bf16 = OPTS[opt]
    _, _, jsearch, _, _ = _jax()
    jm, tm = models(family, bf16)
    prof = search.ModelProfile.from_config(tm.cfg)
    cache, checked = {}, 0
    for spec in search.enumerate_specs(prof, 8, 8):
        jspec = _jax()[1].ParallelSpec(
            **{f: getattr(spec, f) for f in FIELDS})
        cfg = search.reconfigured_cfg(tm.cfg, spec, 8)
        if cfg.pipeline_stages not in cache:  # as auto_accelerate caches
            tmod = tm if cfg is tm.cfg else search._meta_model(tm, cfg)
            cache[cfg.pipeline_stages] = (
                jax_abstract(jsearch.reconfigure_module(jm, jspec, 8),
                             j_opt()),
                search.abstract_state(tmod, t_opt()))
        jab, tab = cache[cfg.pipeline_stages]
        want = jsearch.state_bytes_per_device(jab, jspec)
        got = search.state_bytes_per_device(tab, spec)
        assert got == want, (spec, got, want)
        checked += 1
    assert checked >= 20 and len(cache) == 2


def test_state_bytes_of_an_optimizer_without_a_jax_layout_are_analytic():
    from dlrover_tpu_torch.optim import agd

    _, tm = models("gpt")
    assert search.abstract_state(tm, agd(1e-3)) is None


# ------------------------------------------------------ reconfiguration


@pytest.mark.parametrize("spec,batch", [
    (dict(seq=2), 0), (dict(pipe=2), 0), (dict(pipe=2, data=2), 8),
    (dict(data=8), 0), (dict(fsdp=4, pipe=2), 16)])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_reconfigure_matches_jax(family, spec, batch):
    """The config JAX's ``reconfigure_module`` makes; the same module
    when nothing changes; the weights carried over (a pipelined model's
    layers are the unpipelined one's, by logical layer)."""
    from dlrover_tpu_torch.models.convert import dense_state_dict

    _, _, jsearch, _, _ = _jax()
    jm, _ = models(family)
    cls = GPT if family == "gpt" else Llama
    cfg = (GPTConfig.tiny() if family == "gpt" else LlamaConfig.tiny())
    tm = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    jspec = _jax()[1].ParallelSpec(**spec)
    want = jsearch.reconfigure_module(jm, jspec, batch)
    got = search.reconfigure_module(tm, ParallelSpec(**spec), batch)
    if want is jm:
        assert got is tm
        return
    assert dataclasses.asdict(got.cfg).keys() == dataclasses.asdict(
        tm.cfg).keys()
    for f in ("attn_impl", "pipeline_stages", "pipeline_microbatches"):
        assert getattr(got.cfg, f) == getattr(want.cfg, f), f
    carried = dense_state_dict(got.state_dict(), got.cfg) \
        if got.cfg.pipeline_stages > 1 else got.state_dict()
    base = tm.state_dict()
    assert set(carried) == set(base)
    assert all(torch.equal(carried[n], base[n]) for n in base)
    # And back: a ring model without a seq degree returns to "xla".
    if spec == dict(seq=2):
        back = search.reconfigure_module(got, ParallelSpec(data=8))
        assert back.cfg.attn_impl == jsearch.reconfigure_module(
            want, _jax()[1].ParallelSpec(data=8)).cfg.attn_impl


# ------------------------------------------------------ auto on one process


def token_loss(module, params, batch):
    return loss_fn(module(batch), batch)


def test_auto_on_one_process_ranks_one_candidate():
    res = auto_accelerate(GPT(GPTConfig.tiny(), device="cpu"), adamw(1e-3),
                          np.zeros((2, 16), np.int64), token_loss,
                          device="cpu")
    assert res.spec == ParallelSpec()
    assert [s for s, _ in res.search_ranking] == [ParallelSpec()]
    assert res.search_ranking[0][1].fits(search.HBM_BYTES)


def test_a_candidate_the_port_refuses_is_skipped_and_logged(monkeypatch):
    """The ranking stays the search's; the first candidate the port does
    not place is logged with its refusal, and the next one built."""
    real = search.search_spec

    def ranked(*a, **kw):
        out = real(*a, **kw)
        refused = ParallelSpec(collectives=(("data", "lat"),))
        return [(refused, out[0][1])] + out

    monkeypatch.setattr(search, "search_spec", ranked)
    with port_log() as records:
        res = auto_accelerate(GPT(GPTConfig.tiny(), device="cpu"),
                              adamw(1e-3), np.zeros((2, 16), np.int64),
                              token_loss, device="cpu", search_top_k=2)
    assert res.spec == ParallelSpec()
    assert res.search_ranking[0][0].collectives == (("data", "lat"),)
    assert any("skipping" in r.getMessage() and "item 5" in r.getMessage()
               for r in records)


@pytest.mark.parametrize("kwargs", [
    dict(allow_tensor=True),
    dict(registry=ShardingRegistry().register(r"0\.weight$",
                                              ("mlp", "embed")))])
def test_registry_and_planner_on_plain_models_raise(kwargs):
    """A plain module with ``allow_tensor=True`` or ``registry=`` in a
    one-process job: ``"auto"`` ranks one device, which needs neither
    (JAX annotates a plain model only on a mesh), and it trains there;
    nothing raises (the worlds of 4 below place one on a mesh)."""
    plain = torch.nn.Sequential(torch.nn.Linear(8, 8))

    def loss(module, params, batch):
        return module(batch.float()).square().mean()

    res = auto_accelerate(plain, adamw(1e-3), np.ones((2, 8), np.int64),
                          loss, device="cpu", **kwargs)
    assert res.spec == ParallelSpec() and res.mesh is None
    before = plain[0].weight.detach().clone()
    _, m = res.train_step(res.state, torch.ones((2, 8), dtype=torch.long))
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(plain[0].weight, before)


# ------------------------------------------------------ calibration


class TestCalibratedAgainstChip:
    """The derate rests on the card: ``estimate`` (the port's H100
    defaults) predicts the LLaMA 1.15B windows that ``chip_smoke.py``
    times within +-30%. Measured on one H100 80GB HBM3 at 700.00 W
    (``nvidia-smi``'s name and power limit) by ``chip_smoke.py``: 4 x
    2048 without remat and under "dots", the medians of two rounds of 4
    steps, the windows the card sets (busy 93% and 84%)."""

    MEASURED_MS = {"none": 205.52, "dots": 260.39}

    @pytest.mark.parametrize("policy", ["none", "dots"])
    def test_llama_windows_within_band(self, policy):
        cfg = LlamaConfig.preset(2048)
        if policy == "none":
            cfg = dataclasses.replace(cfg, remat=False)
        est = search.estimate(search.ModelProfile.from_config(cfg),
                              ParallelSpec(), 4, search.HBM_BYTES)
        ratio = est.step_s * 1e3 / self.MEASURED_MS[policy]
        assert 0.7 < ratio < 1.3, ratio


# ------------------------------------------------------ a world of 4


def jax_choice(n, rows):
    """JAX's ranking for the tiny GPT (fp32) on ``n`` devices under the
    port's H100 constants, with its exact state, as its
    ``auto_accelerate`` ranks."""
    import flax.linen as nn
    import jax
    import optax

    jnp, _, _, jgpt, _ = _jax()
    c = CONSTANTS["h100"]
    with pytest.MonkeyPatch.context() as mp:
        jsearch = patch_jax(mp, c)
        jm = jgpt.GPT(dataclasses.replace(jgpt.GPTConfig.tiny(),
                                          dtype=jnp.float32))
        params = jax_abstract(jm, optax.adamw(1e-3), rows)["params"]
        count = sum(int(np.prod(x.shape))
                    for x in jax.tree_util.tree_leaves(nn.meta.unbox(params)))
        prof = jsearch.ModelProfile.from_config(jm.cfg, param_count=count)

        def abstract_fn(sp):
            return jax_abstract(jsearch.reconfigure_module(jm, sp, rows),
                                optax.adamw(1e-3), rows)

        ranked = jsearch.search_spec(prof, n, rows, c["hbm"],
                                     abstract_fn=abstract_fn,
                                     peak_flops=c["peak_flops"],
                                     ici_bw=c["ici_bw"], dcn_bw=c["dcn_bw"])
    return [spec_key(s) for s, _ in ranked]


def jax_plain_choice(n, rows):
    """JAX's ranking for the flax ``PlainLM`` (``allow_tensor=True``: a
    head count of ``n``) on ``n`` devices under the port's H100
    constants, with its unannotated state, as its ``auto_accelerate``
    ranks."""
    import flax.linen as nn
    import jax
    import optax
    from test_torch_registry import flax_models

    c = CONSTANTS["h100"]
    with pytest.MonkeyPatch.context() as mp:
        jsearch = patch_jax(mp, c)
        jm = flax_models()["mha"]()
        params = jax_abstract(jm, optax.adamw(1e-3), rows)["params"]
        count = sum(int(np.prod(x.shape))
                    for x in jax.tree_util.tree_leaves(nn.meta.unbox(params)))
        prof = dataclasses.replace(jsearch.ModelProfile.from_params(count),
                                   num_heads=n)
        ranked = jsearch.search_spec(
            prof, n, rows, c["hbm"],
            abstract_fn=lambda sp: jax_abstract(jm, optax.adamw(1e-3), rows),
            peak_flops=c["peak_flops"], ici_bw=c["ici_bw"],
            dcn_bw=c["dcn_bw"])
    return [spec_key(s) for s, _ in ranked]


def jax_plain_losses(spec_fields, batches):
    """The JAX package's ``auto_accelerate`` of the flax ``PlainLM``
    under the given spec (``allow_tensor=True``) over the first N host
    devices: the losses of ``batches``."""
    import jax
    import optax

    from dlrover_tpu.accel import ParallelSpec as JSpec
    from dlrover_tpu.accel import auto_accelerate as jauto
    from test_torch_registry import flax_models, jax_loss

    spec = JSpec(**dict(zip(FIELDS, spec_fields)))
    batches = [b.astype(np.int32) for b in batches]
    res = jauto(flax_models()["mha"](), optax.adamw(1e-3), batches[0],
                jax_loss, spec=spec, allow_tensor=True,
                devices=jax.devices()[:spec.total])
    state, losses = res.state, []
    for b in batches:
        state, m = res.train_step(state, jax.device_put(b,
                                                        res.batch_sharding))
        losses.append(float(m["loss"]))
    return losses


ROWS, SEQ, STEPS = 8, 16, 3


def plain_batches():
    rng = np.random.default_rng(23)
    return [rng.integers(0, 128, (ROWS, SEQ), dtype=np.int64)
            for _ in range(STEPS)]


def global_batches():
    """One batch, every step (as tests/test_search.py trains)."""
    rng = np.random.default_rng(21)
    return [rng.integers(0, 256, (ROWS, SEQ), dtype=np.int64)] * STEPS


def tiny_gpt(seed=0):
    return GPT(dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32),
               device="cpu", generator=torch.Generator().manual_seed(seed))


def _train(res, batches):
    out = []
    for b in batches:
        _, m = res.train_step(res.state, torch.from_numpy(res.local_batch(b)))
        out.append(float(m["loss"]))
    return out


def worker(path):
    import torch.distributed as dist
    from test_torch_parallel import join_world

    torch.set_num_threads(1)
    join_world()
    rank = int(os.environ["RANK"])
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    batches = global_batches()
    out = {}
    # "auto": the search's choice, trained; the same spec given.
    res = auto_accelerate(tiny_gpt(), adamw(1e-3), batches[0], token_loss,
                          device="cpu")
    out["auto"] = {"spec": spec_key(res.spec),
                   "ranking": [spec_key(s) for s, _ in res.search_ranking],
                   "losses": _train(res, batches)}
    res = auto_accelerate(tiny_gpt(), adamw(1e-3), batches[0], token_loss,
                          spec=res.spec, device="cpu")
    out["explicit"] = _train(res, batches)
    # profile=True: every rank the same winner; no dry-run step reaches
    # the caller's weights.
    model = tiny_gpt(seed=4)
    init = {n: p.detach().clone() for n, p in model.state_dict().items()}
    res = auto_accelerate(model, adamw(1e-3), batches[0], token_loss,
                          device="cpu", profile=True, profile_steps=1,
                          search_top_k=2)
    from dlrover_tpu_torch.accel import sharding

    held = {n: sharding.gather_full(p, sharding.layout_of(p), p.shape)
            for n, p in res.state["params"].items()}
    out["profile"] = {"spec": spec_key(res.spec),
                      "unstepped": all(torch.equal(held[n], init[n])
                                       for n in init),
                      "losses": _train(res, batches)}
    # allow_tensor=False strips tensor candidates.
    res = auto_accelerate(tiny_gpt(), adamw(1e-3), batches[0], token_loss,
                          device="cpu", allow_tensor=False)
    out["no_tensor"] = [spec_key(s) for s, _ in res.search_ranking]
    # A plain module: "auto" with allow_tensor=True.
    from dlrover_tpu_torch.models.convert import plain_from_flax
    from test_torch_registry import token_loss as plain_loss, torch_model

    twin = torch_model("mha")
    twin.load_state_dict(plain_from_flax(inputs["plain_init"], twin))
    res = auto_accelerate(twin, adamw(1e-3), plain_batches()[0], plain_loss,
                          device="cpu", allow_tensor=True)
    out["plain"] = {"spec": spec_key(res.spec),
                    "ranking": [spec_key(s) for s, _ in res.search_ranking],
                    "losses": _train(res, plain_batches())}
    # devices=: this rank's entry of one device a rank; "auto" over 4.
    twin = torch_model("mha")
    twin.load_state_dict(plain_from_flax(inputs["plain_init"], twin))
    res = auto_accelerate(twin, adamw(1e-3), plain_batches()[0], plain_loss,
                          allow_tensor=True,
                          devices=[torch.device("cpu")] * 4)
    out["devices"] = {"spec": spec_key(res.spec), "device": str(res.device),
                      "ranking": [spec_key(s) for s, _ in res.search_ranking],
                      "losses": _train(res, plain_batches())}
    with open(f"{path}.rank{rank}", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    from test_torch_parallel import World

    from test_torch_registry import flax_init

    root = tmp_path_factory.mktemp("search")
    path = str(root / "w4.pkl")
    init = flax_init("mha", plain_batches()[0].astype(np.int32))[1]
    with open(path, "wb") as f:
        pickle.dump({"plain_init": init}, f)
    w = World(4, path, f"search-{uuid.uuid4().hex[:8]}", script=__file__)
    return w.join()


def test_auto_on_four_ranks_chooses_as_jax_and_trains(world4):
    want = jax_choice(4, ROWS)
    for rank in world4:
        assert rank["auto"]["ranking"] == want
        assert rank["auto"]["spec"] == want[0]
        losses = rank["auto"]["losses"]
        assert losses == rank["explicit"]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert len({tuple(r["auto"]["losses"]) for r in world4}) == 1


def test_profiled_auto_agrees_across_ranks_and_leaves_weights(world4):
    specs = {r["profile"]["spec"] for r in world4}
    assert len(specs) == 1
    assert specs.pop() in [tuple(s) for s in world4[0]["auto"]["ranking"]]
    for rank in world4:
        assert rank["profile"]["unstepped"]
        assert rank["profile"]["losses"][-1] < rank["profile"]["losses"][0]


def test_auto_on_a_plain_module_chooses_as_jax_and_trains(world4):
    """A plain module under ``"auto"`` with ``allow_tensor=True`` over 4
    ranks: JAX's ranking, JAX's first choice built, and JAX's losses of
    that spec within 2e-5, every rank alike."""
    want = jax_plain_choice(4, ROWS)
    for rank in world4:
        assert rank["plain"]["ranking"] == want
        assert rank["plain"]["spec"] == want[0]
        assert rank["plain"]["losses"] == world4[0]["plain"]["losses"]
    np.testing.assert_allclose(
        world4[0]["plain"]["losses"],
        jax_plain_losses(want[0], plain_batches()), rtol=2e-5, atol=2e-5)


def test_devices_search_over_their_count_and_train(world4):
    """``devices=`` of four CPU devices on the world of 4 (the plain
    module, ``allow_tensor=True``): every rank trains on its entry, the
    ranking is JAX's ``search_spec`` of 4 devices, and the losses are
    ``"auto"``'s without ``devices`` bit for bit, which
    ``test_auto_on_a_plain_module_chooses_as_jax_and_trains`` holds to
    JAX's ``auto_accelerate(devices=jax.devices()[:4])`` of that spec."""
    want = jax_plain_choice(4, ROWS)
    for rank in world4:
        got = rank["devices"]
        assert got["device"] == "cpu"
        assert got["ranking"] == want and got["spec"] == want[0]
        assert got["losses"] == rank["plain"]["losses"]


@pytest.mark.parametrize("kwargs,match", [
    (dict(devices=[]), "needs 1 devices, have 0"),
    (dict(devices=["cpu", "cpu"]), "needs 1 devices, have 2"),
    (dict(devices=["meta"], device="cpu"), "not devices"),
])
def test_devices_of_another_count_or_device_raise(kwargs, match):
    """One process is a world of one: ``devices`` must list one device,
    and ``device`` (when given too) must be that entry."""
    with pytest.raises(ValueError, match=match):
        auto_accelerate(GPT(GPTConfig.tiny(), device="cpu"), adamw(1e-3),
                        np.zeros((2, 16), np.int64), token_loss, **kwargs)


def test_devices_of_one_trains_on_its_entry():
    res = auto_accelerate(GPT(GPTConfig.tiny(), device="cpu"), adamw(1e-3),
                          np.zeros((2, 16), np.int64), token_loss,
                          devices=[torch.device("cpu")])
    assert res.device == torch.device("cpu") and res.spec == ParallelSpec()


@pytest.mark.parametrize("opt", ["adam8bit", "bf16"])
def test_pipelined_candidates_of_fused_optimizers_are_placed(opt):
    """Every candidate of 8 devices with a pipe degree, on the model the
    search reconfigures for it, meets the port's placement check under
    the 8-bit Adam and fp32 masters exactly as under AdamW (they train on
    pipe ranks: tests/test_torch_pipeline.py): pipe alone or with data
    is placed (in a world of one only the world's size refuses it),
    pipe with another axis is refused for item 6 under each."""
    from dlrover_tpu_torch.accel import accelerate

    cfg = dataclasses.replace(GPTConfig.tiny(), num_layers=8)
    tx = {"adam8bit": lambda: adam8bit(1e-3),
          "bf16": lambda: bf16_master_weights(adamw(1e-3))}[opt]()
    prof = search.ModelProfile.from_config(cfg)
    specs = [sp for sp in search.enumerate_specs(prof, 8, batch_size=16)
             if sp.pipe > 1]

    def outcome(sp, optimizer):
        new = search.reconfigured_cfg(cfg, sp, 16)
        carries = {"stage": new.pipeline_stages > 1, "expert": False}
        try:
            accelerate._check_candidate(sp, new, carries, optimizer, 16)
        except (NotImplementedError, ValueError) as e:
            return type(e).__name__, str(e)
        return None

    placed = 0
    for sp in specs:
        got = outcome(sp, tx)
        assert got == outcome(sp, adamw(1e-3)), sp
        placed += got is not None and "needs a world of 8" in got[1]
    assert placed


def test_allow_tensor_false_strips_tensor_candidates(world4):
    for rank in world4:
        assert rank["no_tensor"]
        assert all(s[FIELDS.index("tensor")] == 1 for s in rank["no_tensor"])


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    worker(sys.argv[1])
