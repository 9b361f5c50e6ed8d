"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled for Hopper
(``sm_90a``) into ``_build/<name>-<hash>.so``, where the hash covers the
source, every header under ``csrc/`` (``*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is. Nothing is built when a module is imported: the first call
that needs a kernel builds it (the CPU tests never do).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBRARIES: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under the CUDA toolkit PyTorch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # any source may include any of them
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_command(name: str, output: Path, compiler: str = "nvcc") -> list[str]:
    return [compiler, *NVCC_FLAGS, "-o", str(output), str(CSRC_DIR / f"{name}.cu")]


def build(names: list[str]) -> dict[str, str]:
    """Compile the named sources that are not built yet, one nvcc each, all
    started together. Returns each compiled source's compiler log (nvcc's
    ``-Xptxas -v`` lines: registers and shared memory per kernel); raises if
    a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        compiler = compiler or nvcc()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        jobs[name] = (out, tmp, subprocess.Popen(
            build_command(name, tmp, compiler),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = {}, []
    for name, (out, tmp, proc) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBRARIES.get(name)
    if lib is None:
        build([name])
        lib = _LIBRARIES[name] = ctypes.CDLL(str(library_path(name)))
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_KERNEL = re.compile(r"\d+(corr_\w+_kernel)I(.*?)EEv")
_TEMPLATE_ARG = re.compile(r"Li(\d+)E|13(__nv_bfloat16)|(f)")


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name with its
    template arguments, registers per thread and spill bytes."""
    lines, name = [], None
    for line in log.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            kernel = _KERNEL.search(entry.group(1))
            name = entry.group(1)
            if kernel:
                args = [a or ("bf16" if b else "float") for a, b, _ in _TEMPLATE_ARG.findall(kernel.group(2))]
                name = f"{kernel.group(1)}<{', '.join(args)}>"
            spills = "?"
        elif name and "spill stores" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            registers = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{name}: {registers} registers; {spills}")
            name = None
    return lines
