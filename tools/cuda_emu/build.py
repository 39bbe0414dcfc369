#!/usr/bin/env python3
"""Build one of the port's CUDA sources for the CPU, against cuda_emu.h:

    python3 tools/cuda_emu/build.py src/repro_torch/kernels/ssd_scan/csrc/ssd_bwd.cu OUT.so

The source's launches (``kernel<<<grid, block, smem, stream>>>(...)``, all
four arguments written) become calls of ``emu_launch``, its ``extern
__shared__`` array a pointer into the emulator's buffer; g++ (C++20,
``-ffp-contract=off``, so no product is fused into a sum that the card would
round apart; the source's own directory on the include path, for its headers)
builds the rest as it stands into a shared library with the
same ``extern "C"`` entries, which ctypes loads and calls with CPU tensors'
``data_ptr()``.  It takes a few seconds; a run switches between one fiber
per CUDA thread on one core, so keep the shapes small.
"""
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    src, out = Path(argv[0]), Path(argv[1])
    text = src.read_text()
    text = re.sub(r"#include <cuda_(bf16|runtime)\.h>", "", text)
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_dyn_smem);", text)
    text = re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(", r"emu_launch(\1, \2, ",
                  text, flags=re.S)
    cpp = out.with_suffix(".cpp")
    cpp.write_text('#include "cuda_emu.h"\n' + text)
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-I", str(HERE), "-I", str(src.resolve().parent), "-o", str(out), str(cpp), "-Wall",
         "-Wno-unused-variable", "-Wno-unknown-pragmas", "-Wno-unused-function"],
        capture_output=True, text=True)
    sys.stdout.write(proc.stdout + proc.stderr)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
