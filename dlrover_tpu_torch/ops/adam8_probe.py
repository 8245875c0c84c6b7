"""Ablations of the 8-bit Adam kernel, on the card.

Builds variants of ``csrc/adam8bit.cu``, each a list of text
replacements of the committed source, into libraries of their own under
``build/probe/``, and times each one's fused launch over a whole step of
GPT-2 xl's 1,557,611,200 bf16 params (16 leaves, one launch, 40 launches
after 3), beside the bound from the bytes the step must move:

- ``copy``: the same table walk, loads and stores (every byte the step
  moves, in the same pattern), nothing between them: the floor this
  access pattern reaches;
- ``no_sqrt_div``: the kernel with each value's square root and division
  replaced by a multiply: what the rest costs;
- ``committed``: the kernel as built;
- ``plain_cvt``: the conversions by cvt instructions, not bit tricks;
- ``stages_1`` / ``stages_2`` / ``stages_4``: blocks a warp has in
  flight, not 3 (1: each block loaded only when its turn comes);
- ``ctas_2`` / ``ctas_4``: 2 or 4 CTAs an SM (the grid and the register
  budget), not 3;
- ``l2_hint``: each 16-byte cp.async asks L2 to fetch 256 bytes.

Beside them, two yardsticks of what the card's memory gives a stream of
reads and writes: ATen's copy of a 3 GiB bf16 tensor (one read, one
write a value), ``torch.add`` into a third (two reads, one write) and
in place (``add_``: two reads, one write over one of them, as the step
updates p and its state), each timed the same way, with its bytes over
its time. ``committed`` is
timed again last, to show the drift of the run.

The variants that keep the arithmetic are also held to the plain version
(``low_bit.adam8_errors``) on a chunked and a straddling leaf.

    python -m dlrover_tpu_torch.ops.adam8_probe [variant ...]

Needs an NVIDIA card and nvcc; nothing runs on import.
"""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import torch

from dlrover_tpu_torch.ops import build
from dlrover_tpu_torch.optim import low_bit as lowbit

SOURCES = build.CSRC  # the committed sources every variant starts from
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 bytes/s

_COMPUTE = (
    "  const float cm = __fmul_rn(msc, h.b1_127);\n",
    "  Words<T> out;\n",
)
# Between the loads and the stores: o = o + g (or g), moments and
# scales written back as they were read.
_COPY = ("  const uint32_t nm[2] = {mw.x, mw.y}, ns[2] = {sw.x, sw.y};\n"
         "  const float amax_m = msc, amax_s = ssc;\n"
         "#pragma unroll\n"
         "  for (int i = 0; i < PER_LANE; ++i) o[i] = FUSED ? o[i] + g[i] "
         ": g[i];\n")

VARIANTS = {
    "committed": [],
    "copy": [("adam8bit.cu", None, _COPY)],
    "no_sqrt_div": [
        ("adam8bit.cu", "      s[i] = __fsqrt_rn(v);\n",
         "      s[i] = __fmul_rn(v, 0.5f);\n"),
        ("adam8bit.cu",
         "          __fdiv_rn(__fmul_rn(lr_eff, m[i]), __fadd_rn(denom, "
         "eps_eff));\n",
         "          __fmul_rn(__fmul_rn(lr_eff, m[i]), __fadd_rn(denom, "
         "eps_eff));\n"),
    ],
    "plain_cvt": [
        ("adam8bit.cu",
         "  return __fsub_rn(\n"
         "      __int_as_float(__byte_perm(word_x80, 0x4B000000u, "
         "0x7540 | K)),\n"
         "      8388736.0f);\n",
         "  return (float)(int8_t)((word_x80 ^ 0x80808080u) >> (8 * K));\n"),
        ("adam8bit.cu",
         "  return __float_as_uint(__fadd_rn(x, 12582912.0f));\n",
         "  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(x);\n"),
        ("adam8bit.cu",
         "  const float t = __fadd_rd(y, 8388608.0f);\n"
         "  byte = __float_as_uint(t);\n"
         "  return __fsub_rn(t, 8388608.0f);\n",
         "  const float f = floorf(y);\n"
         "  byte = (uint32_t)(uint8_t)(int8_t)(int)f;\n"
         "  return f;\n"),
    ],
    "stages_1": [("adam8bit.cu", "constexpr int STAGES = 3;",
                  "constexpr int STAGES = 1;")],
    "stages_2": [("adam8bit.cu", "constexpr int STAGES = 3;",
                  "constexpr int STAGES = 2;")],
    "stages_4": [("adam8bit.cu", "constexpr int STAGES = 3;",
                  "constexpr int STAGES = 4;")],
    "ctas_2": [("adam8bit.cu", "constexpr int CTAS = 3;",
                "constexpr int CTAS = 2;")],
    "ctas_4": [("adam8bit.cu", "constexpr int CTAS = 3;",
                "constexpr int CTAS = 4;")],
    "l2_hint": [("adam8bit.cu", "cp.async.cg.shared.global [%0], [%1], 16;",
                 "cp.async.cg.shared.global.L2::256B [%0], [%1], 16;")],
}
EXACT = ("committed", "plain_cvt", "stages_1", "stages_2", "stages_4",
         "ctas_2", "ctas_4", "l2_hint")


def _replace(text: str, name: str, old, new) -> str:
    if old is None:  # the whole span between the loads and the stores
        a = text.find(_COMPUTE[0])
        b = text.find(_COMPUTE[1])
        if a < 0 or b < 0 or text.count(_COMPUTE[0]) != 1:
            raise ValueError(f"{name}: the arithmetic span is not found")
        return text[:a] + new + text[b:]
    if text.count(old) != 1:
        raise ValueError(f"{name}: {old!r} is not in the source once")
    return text.replace(old, new)


def variant_source(name: str) -> str:
    """A copy of csrc/ with the variant's replacements, under build/."""
    out = os.path.join(os.path.dirname(build.BUILD_DIR), "probe",
                       f"adam8_{name}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(SOURCES, out)
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(out, fname)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(_replace(text, name, old, new))
    return out


def time_ms(fn, iters=40, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def xl_step():
    """GPT-2 xl's params (bf16, random from seed 0), gradients and the
    bound ``adam8bit`` with a random state; and the bytes a fused step
    must move (each input read once, each output written once)."""
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = dataclasses.replace(GPTConfig.gpt2_xl(), remat=False,
                              param_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPT(cfg, device="cuda", generator=gen)
    params = dict(model.named_parameters())
    grads = [(torch.randn(p.shape, generator=gen, device="cuda") * 1e-3)
             .to(p.dtype) for p in params.values()]
    opt = lowbit.adam8bit(2e-4)(params.items())
    for qt in list(opt.state.m.values()) + list(opt.state.v.values()):
        qt.q.copy_(torch.randint(-127, 128, qt.q.shape, generator=gen,
                                 device="cuda", dtype=torch.int8))
        qt.scale.copy_(torch.rand(qt.scale.shape, generator=gen,
                                  device="cuda") * 1e-3)
    values = sum(p.numel() for p in params.values())
    blocks = sum(qt.scale.numel() for qt in opt.state.m.values())
    nbytes = values * 2 * 3 + 2 * 2 * blocks * 256 + 2 * 2 * blocks * 4 + 8
    return opt, params, grads, nbytes


def yardsticks():
    """GB/s of ATen's copy (a read and a write a value), of torch.add
    into a third tensor and in place (two reads, one write), on 3 GiB
    bf16 tensors."""
    n = 3 * 2 ** 30 // 2
    a, b, c = (torch.empty(n, dtype=torch.bfloat16, device="cuda")
               for _ in range(3))
    a.normal_()
    b.normal_()
    out = {}
    for name, fn, nbytes in (
            ("aten_copy", lambda: c.copy_(a), 4 * n),
            ("aten_add", lambda: torch.add(a, b, out=c), 6 * n),
            ("aten_add_in_place", lambda: a.add_(b), 6 * n)):
        ms = time_ms(fn)
        out[name] = {"ms": ms, "gb_s": nbytes / ms / 1e6,
                     "share_of_hbm": nbytes / ms / 1e-3 / HBM_BYTES_S}
    del a, b, c
    torch.cuda.empty_cache()
    return out


def check_cases():
    """(label, g, p, qm, qv, shape, hp): a chunked leaf and a leaf whose
    blocks straddle members of 37 values."""
    rng = np.random.default_rng(1)
    hp = lowbit._Hyper(2e-4, 0.9, 0.999, 1e-8, 0.0, 256)

    def t(shape, scale, dtype=torch.bfloat16):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=dtype, device="cuda")

    for label, layers, member in (("chunked [6, 300, 70]", 6, (300, 70)),
                                  ("straddling [7, 37]", 7, (37,))):
        shape = (layers,) + member
        yield (label, [t(member, 1e-2) for _ in range(layers)],
               [t(member, 2e-2) for _ in range(layers)],
               lowbit._quantize_leaf(t(shape, 1e-3, torch.float32), 256),
               lowbit._quantize_leaf(t(shape, 1e-3, torch.float32).abs(),
                                     256), shape, hp)


def probe(name, opt, params, grads, nbytes):
    build.CSRC = variant_source(name)
    build._LIBS.clear()
    _, _, ptxas = build.build("adam8bit")
    res = {"ptxas": [ln.strip() for ln in ptxas.splitlines()
                     if "registers" in ln or "spill" in ln]}
    opt._cache = None  # a table bound to this variant's library
    live = list(params.values())
    opt.update_and_apply(grads, live)
    table = opt._cache[1][0]
    bc = 1 - torch.tensor([0.9, 0.999], device="cuda") ** 3.0
    hp = opt.tx.hp
    res["ms"] = time_ms(lambda: table.launch(True, bc, hp))
    res["wrapper_step_ms"] = time_ms(lambda: opt.update_and_apply(grads,
                                                                  live))
    res["hbm_share"] = nbytes / HBM_BYTES_S * 1e3 / res["ms"]
    if name in EXACT:
        worst = {}
        for label, g, p, qm, qv, shape, lhp in check_cases():
            for fused in (False, True):
                got, ref = lowbit.kernel_and_plain(
                    g, qm, qv, bc, shape, lhp, p=p if fused else None)
                errs = lowbit.adam8_errors(got, ref)
                bad = lowbit.adam8_failures(errs)
                if bad:
                    raise RuntimeError(f"{name} {label} fused={fused}: {bad}")
                worst[f"{label} {'fused' if fused else 'update'}"] = \
                    errs["q_mismatches"]
        res["q_mismatches"] = worst
    return res


def main(names):
    if not torch.cuda.is_available():
        print("adam8_probe: CUDA is not available", file=sys.stderr)
        return 2
    opt, params, grads, nbytes = xl_step()
    print("step", json.dumps({
        "values": sum(p.numel() for p in params.values()),
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_S * 1e3,
        "leaves": len(opt._leaves),
        "card": torch.cuda.get_device_name(0)}), flush=True)
    print("yardsticks", json.dumps(yardsticks()), flush=True)
    for name in names or list(VARIANTS) + ["committed"]:
        print(name, json.dumps(probe(name, opt, params, grads, nbytes)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
