#!/usr/bin/env python3
"""Variants of the f32/bf16 decode kernel (B1), timed in turns on one card.

    python3 tools/b1_variants.py [NAME ...]

Builds copies of ``deeplearning4j_tpu_torch/csrc/decode_attention.cu``
changed by the source substitutions below, one ``nvcc`` each, all at
once (the flags of ``kernels/_build.py``, into the git-ignored
``_chipcheck/b1_variants/``), loads each with ctypes, holds each against
the plain version, and times each at B1's phase-3 shapes in two turns
(the variants in order, then reversed) with ``chip_smoke.time_ms``:

- ``row1a``: f32, 64 slots, 2 heads of 16, T = 1024, every slot full
  (the default draft's shape, phase 12b);
- ``row1``: f32, 32 slots, 8 heads of 64, T = 1024, every slot full
  (the served shape, phase 4), and ``row1_ragged`` with random lengths;
- ``bf16``: row 1 over bf16 caches; ``d128``: f32, 32 slots of 4 heads
  of 128.

Variants:

- ``base``: the source as it is;
- ``no_merge``: timing only, wrong results: no block stores its partial
  into rank 0 and rank 0 waits for none (the cost of the merge);
- ``no_cluster``: ``no_merge`` launched without clusters (the split
  kernel's loads and folds alone);
- ``ldcs``: 16-byte K/V loads with the evict-first hint (``__ldcs``);
- ``regs16``: 16 registers of K a lane a tile (tiles twice as tall);
- ``cluster4``: 4 blocks a (slot, head) over chunks of 256 keys.

Each variant prints one ``VAR name {shape: [ms, ms]}`` line.
"""
import ctypes
import json
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.kernels import _build  # noqa: E402
from deeplearning4j_tpu_torch.kernels import decode_attention as da  # noqa

OUT = os.path.join(ROOT, "_chipcheck", "b1_variants")


def _sub(src, old, new):
    if old not in src:
        raise ValueError(f"substitution does not apply: {old[:60]!r}")
    return src.replace(old, new)


def _const(src, name, value):
    return re.sub(rf"(constexpr int {name} = )\d+", rf"\g<1>{value}", src)


def variants(src):
    no_merge = _sub(_sub(
        src, "    sm90::cluster_wait();\n    const uint32_t base",
        "    return;\n    const uint32_t base"),
        "  if (nb > 1) sm90::mbar_wait<true>(&sm.bar, 0);\n", "")
    no_cluster = _sub(_sub(
        no_merge, "__cluster_dims__(1, kCluster, 1) ", ""),
        "  __syncwarp();\n  sm90::cluster_arrive();\n", "")
    return {
        "base": src,
        "no_merge": no_merge,
        "no_cluster": _sub(no_cluster, "    sm90::fence_mbar_init();\n", ""),
        "ldcs": _sub(src, "__ldg(reinterpret_cast<const uint4*>",
                     "__ldcs(reinterpret_cast<const uint4*>"),
        "regs16": _const(src, "kLaneRegs", 16),
        "cluster4": _const(_const(src, "kChunk", 256), "kCluster", 4),
    }


def build(names, srcs):
    procs = {}
    for n in names:
        d = os.path.join(OUT, n)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "decode_attention.cu"), "w") as f:
            f.write(srcs[n])
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
               "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "decode_attention.cu")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {n}:\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, n, "lib.so"))
        for fn, args in da._SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        libs[n] = lib
        regs = sorted({int(x) for x in re.findall(r"Used (\d+) registers",
                                                  log)})
        print(f"built {n}: registers {regs[0]}..{regs[-1]}", flush=True)
    return libs


def main():
    if not torch.cuda.is_available():
        print("b1_variants: no CUDA device", file=sys.stderr)
        return 2
    with open(_build.CSRC_DIR / "decode_attention.cu") as f:
        srcs = variants(f.read())
    names = sys.argv[1:] or list(srcs)
    libs = build(names, srcs)
    dev = torch.device("cuda")
    print(f"device: {cs.card_line()}")
    g = torch.Generator(device="cpu").manual_seed(1)
    shapes = {"row1a": (64, 2, 16, torch.float32),
              "row1": (32, 8, 64, torch.float32),
              "bf16": (32, 8, 64, torch.bfloat16),
              "d128": (32, 4, 128, torch.float32)}
    T = 1024
    data = {}
    for key, (S, H, D, dt) in shapes.items():
        q = torch.randn((S, H, D), generator=g).to(dev)
        k, v = (torch.randn((S, H, T, D), generator=g).to(dev, dt)
                for _ in range(2))
        full = torch.full((S,), T, dtype=torch.int32, device=dev)
        ragged = torch.randint(0, T + 1, (S,), generator=g).to(
            dev, torch.int32)
        data[key] = (q, k, v, full, ragged)

    def call(n, key, lens):
        q, k, v = data[key][:3]
        S, H, _, D = k.shape
        out = torch.empty((S, H, D), device=dev)
        fn = (libs[n].decode_attention_f32 if k.dtype == torch.float32
              else libs[n].decode_attention_bf16)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lens.data_ptr(), out.data_ptr(), S, H, T, D,
                        1.0 / math.sqrt(D),
                        torch.cuda.current_stream().cuda_stream), n)
        return out

    for n in names:
        errs = {}
        for key, (q, k, v, _, ragged) in data.items():
            got = call(n, key, ragged)
            want = da.decode_attention_torch(q, k, v, ragged)
            errs[key] = (got - want).abs().max().item()
        print(f"{n}: max_abs_err vs plain {errs}")
    res = {n: {} for n in names}
    for order in (names, names[::-1]):
        for n in order:
            for key in data:
                res[n].setdefault(key, []).append(cs.time_ms(
                    lambda: call(n, key, data[key][3]), iters=50))
            res[n].setdefault("row1_ragged", []).append(cs.time_ms(
                lambda: call(n, "row1", data["row1"][4]), iters=50))
    for n in names:
        print(f"VAR {n} {json.dumps(res[n])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
