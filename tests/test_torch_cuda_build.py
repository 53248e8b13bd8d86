"""The kernel build's ptxas log in the torch port (`ops/cuda_build.py`), on
the CPU with a stand-in compiler.

`build` keeps each library's compiler output beside it (``.log``), so that
a process that finds the library already built still has its ptxas report
in `build_logs` (chip_smoke.py holds K7w's record to no spill from it). The
stand-in `nvcc` (a shell script under a temporary CUDA_HOME) writes the
output file and prints a ptxas-like line; no CUDA compiler is needed.
"""
import stat

import pytest

from deeplearning4j_torch.ops import cuda_build

REPORT = "ptxas info    : Used 40 registers, 0 bytes spill stores"


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    # the output path follows "-o"; count the calls in a file
    nvcc.write_text("#!/bin/sh\n"
                    f"echo x >> {tmp_path}/calls\n"
                    "while [ \"$1\" != \"-o\" ]; do shift; done\n"
                    "echo lib > \"$2\"\n"
                    f"echo '{REPORT}'\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "toy.cu").write_text("// a toy source\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "build_logs", {})
    return tmp_path


def test_a_built_library_keeps_its_ptxas_log(stand_in):
    lib, = cuda_build.build(["toy"])
    assert lib.exists() and REPORT in cuda_build.build_logs["toy"]
    assert REPORT in lib.with_suffix(".log").read_text()
    # a later process finds the library built: no compile, the same log
    cuda_build.build_logs.clear()
    assert cuda_build.build(["toy"]) == [lib]
    assert REPORT in cuda_build.build_logs["toy"]
    assert (stand_in / "calls").read_text().count("x") == 1
    assert not [p for p in lib.parent.iterdir() if "tmp" in p.suffix]
