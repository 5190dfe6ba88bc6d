"""Build the port's CUDA sources for the CPU: every ``k<<<grid, block, smem,
stream>>>(args)`` launch in ``csrc/*.cu`` is rewritten to ``emu_launch(grid,
block, k, args)`` (blocks one after another, a block's threads as fibers
that meet at warp collectives, ``cuda_runtime.h`` here) and each file is
compiled with g++ into ``lib<name>.so``.

    python scripts/cuda_emu/build.py OUT_DIR [CSRC_DIR]

CSRC_DIR defaults to ``src/repro_torch/kernels/csrc``.  A rehearsal of the
kernels' own code before a run on the card; it says nothing of the GPU's
compiler or of timing.
"""
from __future__ import annotations

import pathlib
import re
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
LAUNCH = re.compile(r"([A-Za-z_][\w:]*(?:<[^;{}]*?>)?)\s*<<<(.*?)>>>\s*\(", re.S)


def rewrite(src: str) -> str:
    """``src`` with every triple-chevron launch replaced by ``emu_launch``."""
    out, pos = [], 0
    while (m := LAUNCH.search(src, pos)) is not None:
        depth, j = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[j], 0)
            j += 1
        grid, block = [c.strip() for c in m.group(2).split(",")][:2]
        out.append(src[pos:m.start()]
                   + f"emu_launch(dim3({grid}), dim3({block}), {m.group(1)}, {src[m.end():j - 1]})")
        pos = j
    return "".join(out) + src[pos:]


def main(argv: list[str]) -> int:
    out = pathlib.Path(argv[1])
    csrc = pathlib.Path(argv[2]) if len(argv) > 2 else (
        HERE.parents[1] / "src" / "repro_torch" / "kernels" / "csrc")
    out.mkdir(parents=True, exist_ok=True)
    for cu in sorted(csrc.glob("*.cu")):
        cpp = out / f"{cu.stem}.cpp"
        cpp.write_text(rewrite(cu.read_text()))
        subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                        "-U_FORTIFY_SOURCE",  # the fibers' longjmp crosses stacks
                        "-I", str(HERE), "-o", str(out / f"lib{cu.stem}.so"), str(cpp)],
                       check=True)
        print("built", out / f"lib{cu.stem}.so")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
