#!/usr/bin/env python3
"""Where the STAR and BRIEF kernels spend their time on the card.

    python3 tools/star_stage_clocks.py    # from the repository root; needs
                                          # one CUDA device and nvcc

STAR: builds an instrumented copy of csrc/star.cu into
build/torch_kernels/star_clocks/. Thread 0 of each block records clock64
at the start of the tile, after each block barrier and at the end.
The copy then runs star_tile_staged on a 640x480 blob frame under the s3
settings. The script prints each stage's cycles a block (mean and max over
the 132 blocks), the instrumented kernel's device µs a launch beside the
library kernel's (CUDA graphs of 200 launches), and the SM clock those
imply.

BRIEF: the SASS instruction mix of brief_planes_s256 in the library
(cuobjdump). Its loop body runs once a pixel and is most of the code, so
the count is about the instructions a pixel.

The card's name and power limit are printed first. Results also go to
chiprun_out/star_stage_clocks.json.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from openekfmonoslam_tpu_torch.ops import cuda_lib  # noqa: E402
from openekfmonoslam_tpu_torch.ops import star_kernel  # noqa: E402
from openekfmonoslam_tpu_torch.vision import star  # noqa: E402

OUT_DIR = cuda_lib.BUILD_DIR / "star_clocks"
SLOTS = 8
# slot -> the stage that ends there (the barriers of star.cu in text
# order; slot 5 is the row max's own pass, taken only for NMS radius > 4)
STAGES = {1: "staging", 2: "A response", 3: "B gradients",
          4: "C-D-E1 sums, gate, row max", 5: "E1 row max (r > 4)",
          7: "E2 column max, test, stores"}


def instrumented_source() -> str:
    """csrc/star.cu with a clock64 mark after every __syncthreads(), at
    the start of star_tile and at its end."""
    src = (cuda_lib.CSRC / "star.cu").read_text()
    head = f'''
__device__ long long star_clk[4096][{SLOTS}];
#define STAR_CLK(n) \\
    if (threadIdx.x == 0) \\
        star_clk[blockIdx.y * gridDim.x + blockIdx.x][n] = clock64();
EKF_EXPORT int star_clocks(long long* host, int blocks) {{
    return (int)cudaMemcpyFromSymbol(
        host, star_clk, (size_t)blocks * {SLOTS} * sizeof(long long));
}}
'''
    src = src.replace('#include "common.cuh"',
                      '#include "common.cuh"\n' + head, 1)
    count = iter(range(1, 7))
    src = re.sub(r"__syncthreads\(\);",
                 lambda m: f"__syncthreads(); STAR_CLK({next(count)})", src)
    src = src.replace("    extern __shared__ float smem[];",
                      "    extern __shared__ float smem[];\n    STAR_CLK(0)", 1)
    end = src.index("}  // namespace")
    close = src.rindex("}", 0, end)
    return src[:close] + "    STAR_CLK(7)\n" + src[close:]


def build() -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu = OUT_DIR / "star_clocks.cu"
    cu.write_text(instrumented_source())
    so = OUT_DIR / "libstar_clocks.so"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
                    str(cuda_lib.CSRC), str(cu), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.ekf_star.argtypes = cuda_lib._SIGNATURES["ekf_star"]
    lib.ekf_star.restype = ctypes.c_int
    lib.star_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def star_stages(dev) -> dict:
    h, w = chip_smoke.LIVE_HW
    gray = torch.tensor(chip_smoke.blob_texture(np.random.default_rng(0),
                                                h, w), device=dev)
    s = star_kernel.StarSettings()
    ii = star._integral(gray, star.integral_pad(s.max_size))
    params = star_kernel.star_params(h, w, ii.shape[1], s)
    raw = torch.empty((h, w), device=dev)
    nms = torch.empty_like(raw)
    lib = build()

    def launch():
        rc = lib.ekf_star(ii.data_ptr(), ctypes.byref(params), 1,
                          raw.data_ptr(), nms.data_ptr(),
                          cuda_lib.stream_of(ii))
        if rc:
            raise RuntimeError(f"ekf_star: CUDA error {rc}")

    for _ in range(20):
        launch()
    torch.cuda.synchronize()
    raw_p, nms_p = star_kernel.star_plain(ii, h, w, s)
    if not (torch.equal(raw, raw_p) and torch.equal(nms, nms_p)):
        raise RuntimeError("the instrumented STAR kernel disagrees with the "
                           "plain version")
    e = 3 + s.nms_radius
    blocks = (-(-w // (star_kernel.FRAME_W - 2 * e))
              * -(-h // star_kernel.TILE_H))
    buf = (ctypes.c_longlong * (blocks * SLOTS))()
    lib.star_clocks(buf, blocks)
    clk = np.array(buf, dtype=np.int64).reshape(blocks, SLOTS)
    stages, prev = {}, clk[:, 0]
    for slot, name in STAGES.items():
        if s.nms_radius <= 4 and slot == 5:
            continue
        d = clk[:, slot] - prev
        prev = clk[:, slot]
        stages[name] = {"mean": float(d.mean()), "max": int(d.max())}
    total = clk[:, 7] - clk[:, 0]
    inst_us = chip_smoke.graph_ms(launch) * 1e3
    lib_us = chip_smoke.graph_ms(
        lambda: star_kernel.star_cuda(ii, h, w, s)) * 1e3
    return {"blocks": blocks, "stages_cycles": stages,
            "block_cycles": {"mean": float(total.mean()),
                             "max": int(total.max())},
            "instrumented_us": inst_us, "library_us": lib_us,
            "implied_ghz": float(total.max()) / inst_us / 1e3}


def brief_sass() -> dict:
    """Opcode counts of brief_planes_s256's SASS."""
    path = cuda_lib.library().path
    sass = subprocess.run(
        [str(Path(cuda_lib._nvcc()).parent / "cuobjdump"), "-sass",
         str(path)], capture_output=True, text=True, check=True).stdout
    body = sass.split("Function : ")
    fn = next(b for b in body if b.startswith("_Z17brief_planes_s256"))
    ops = collections.Counter(
        m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn))
    return {"instructions": sum(ops.values()),
            "top": dict(ops.most_common(8))}


def main() -> int:
    if not torch.cuda.is_available():
        print("star_stage_clocks: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    report = {"card": chip_smoke.smi_line(), "star": star_stages(dev),
              "brief_s256_sass": brief_sass()}
    st = report["star"]
    print(f"STAR star_tile_staged, 640x480, s3 settings, {st['blocks']} "
          f"blocks: cycles a block, mean (max)")
    for name, v in st["stages_cycles"].items():
        print(f"  {name}: {v['mean']:.0f} ({v['max']})")
    print(f"  block: {st['block_cycles']['mean']:.0f} "
          f"({st['block_cycles']['max']}); instrumented "
          f"{st['instrumented_us']:.2f} us a launch, library "
          f"{st['library_us']:.2f} us; {st['implied_ghz']:.2f} GHz implied")
    b = report["brief_s256_sass"]
    print(f"BRIEF brief_planes_s256 SASS: {b['instructions']} instructions, "
          f"top {b['top']}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "star_stage_clocks.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
