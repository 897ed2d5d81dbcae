"""PyTorch port, kernel builds: the library a CUDA source loads is named by
a hash of everything its build reads, so an edited source, an edited
header it includes or changed nvcc flags never load a stale library from
`build/`. Runs on the CPU: nothing is compiled."""

import shutil

import pytest
import torch

from megatron_llm_tpu_torch.ops import _build
from megatron_llm_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def csrc(tmp_path):
    """A copy of the port's csrc/ to edit."""
    return shutil.copytree(_build.CSRC, tmp_path / "csrc")


def _edit(path, text="\n// edited\n"):
    path.write_text(path.read_text() + text)


def test_flash_source_includes_the_hopper_header(csrc):
    assert _build.included_headers(csrc / "flash_attention.cu", csrc) == [
        csrc / "hopper.cuh"]


@pytest.mark.parametrize("edited", ["flash_attention.cu", "hopper.cuh"])
def test_editing_the_source_or_its_header_renames_the_library(csrc, edited):
    before = _build.library_path("flash_attention.cu", csrc)
    assert _build.library_path("flash_attention.cu", csrc) == before
    _edit(csrc / edited)
    after = _build.library_path("flash_attention.cu", csrc)
    assert after != before
    assert after.parent == _build.BUILD_DIR
    assert after.name.startswith("libflash_attention-")


def test_a_header_the_source_does_not_include_changes_nothing(csrc):
    # paged_attention.cu includes no csrc header (decode_attention.cu now
    # includes hopper.cuh for its mma.sync design)
    assert _build.included_headers(csrc / "paged_attention.cu", csrc) == []
    before = {s: _build.library_path(s, csrc)
              for s in ("paged_attention.cu",)}
    _edit(csrc / "hopper.cuh")
    (csrc / "unused.cuh").write_text("#pragma once\n")
    assert {s: _build.library_path(s, csrc) for s in before} == before


def test_headers_are_followed_through_other_headers(csrc):
    (csrc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("#pragma once\n")
    (csrc / "k.cu").write_text('#include <stdint.h>\n#include "outer.cuh"\n')
    assert _build.included_headers(csrc / "k.cu", csrc) == [
        csrc / "inner.cuh", csrc / "outer.cuh"]
    before = _build.library_path("k.cu", csrc)
    _edit(csrc / "inner.cuh")
    assert _build.library_path("k.cu", csrc) != before


def test_nvcc_flags_rename_the_library(csrc, monkeypatch):
    before = _build.library_path("flash_attention.cu", csrc)
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build.library_path("flash_attention.cu", csrc) != before


def test_k6_rows_are_padded_to_whole_16_byte_units():
    """K6 loads each group's lse and delta rows by TMA, whose boxes start
    on 16-byte boundaries: `_rows4` pads every group's row to a multiple
    of 4 values with zeros, and passes rows that already are as they are."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3, 1)
    assert fa._rows4(x, 2, 3).tolist() == [[0, 1, 2, 0], [3, 4, 5, 0]]
    whole = torch.ones(2, 4, 1)
    assert fa._rows4(whole, 2, 4) is whole


def test_k5_and_k6_take_rows_padded_once():
    """`_bwd` pads lse and delta once and hands the same rows to K5 and
    K6; their wrappers refuse rows that were not padded."""
    fa._check_rows4(2, 3, fa._rows4(torch.ones(2, 3, 1), 2, 3))
    fa._check_rows4(2, 4, torch.ones(2, 4, 1))
    with pytest.raises(ValueError, match="multiple of 4"):
        fa._check_rows4(2, 3, torch.ones(2, 3, 1))


FAKE_NVCC = """#!{python}
import os, sys, time
with open({count!r}, "a") as f:
    f.write("x")
time.sleep(0.5)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as f:
    f.write("built")
"""

RANK = """
import sys
from pathlib import Path
from megatron_llm_tpu_torch.ops import _build
print(_build.build_library("flash_attention.cu", Path(sys.argv[1]),
                           Path(sys.argv[2]), nvcc=sys.argv[3]))
"""


def test_ranks_starting_together_build_each_library_once(csrc, tmp_path):
    """Four processes that start together (torchrun's ranks) build the
    library once, under the build directory's lock, and all name the
    same file; the fake compiler counts its runs."""
    import os
    import subprocess
    import sys

    count = tmp_path / "count"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable,
                                     count=str(count)))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(_build.CSRC.parent.parent))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(csrc), str(build), str(nvcc)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for _ in range(4)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
        outs.append(out.strip().splitlines()[-1])
    assert count.read_text() == "x"
    assert len(set(outs)) == 1
    lib = build / os.path.basename(outs[0])
    assert lib.read_text() == "built"
    assert lib == _build.library_path("flash_attention.cu", csrc, build)
