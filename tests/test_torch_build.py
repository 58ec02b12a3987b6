"""The kernel build cache (``repro_torch.kernels.build``) on the CPU: a
library's path is keyed by its sources and by every header they include,
so that an edited header (``kernels/csrc/hopper.cuh``, shared by the bf16
kernels) builds anew instead of loading a stale library. Nothing here
compiles: ``nvcc`` runs on a card's machine only."""

import shutil

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel

HEADER = build.BUILD_ROOT.parent / "csrc" / "hopper.cuh"
LIBRARIES = {**attn_kernel.LIBRARIES, **ssd_kernel.LIBRARIES}


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_the_bf16_libraries_hash_the_shared_header(name):
    """Each flash and SSD library's sources include the header (its bf16
    kernel does), and the hash covers it."""
    files = build.with_headers(LIBRARIES[name])
    assert HEADER.resolve() in files
    assert files[:len(LIBRARIES[name])] == [s.resolve()
                                            for s in LIBRARIES[name]]


def test_editing_a_header_changes_the_library_path(tmp_path):
    """A copy of the SSD backward's sources and the header: editing the
    header alone moves the library to a new path; undoing the edit moves
    it back."""
    csrc = tmp_path / "kernels" / "csrc"
    ssd = tmp_path / "kernels" / "ssd" / "csrc"
    csrc.mkdir(parents=True)
    ssd.mkdir(parents=True)
    shutil.copy(HEADER, csrc / HEADER.name)
    sources = []
    for src in ssd_kernel.BWD_SOURCES:
        shutil.copy(src, ssd / src.name)
        sources.append(ssd / src.name)
    header = csrc / HEADER.name
    before = build.library_path("ssd_scan_bwd", sources)
    text = header.read_text()
    header.write_text(text + "\n// an edit\n")
    after = build.library_path("ssd_scan_bwd", sources)
    assert after != before
    assert after.name == before.name == "libssd_scan_bwd.so"
    header.write_text(text)
    assert build.library_path("ssd_scan_bwd", sources) == before


def test_a_source_without_includes_hashes_alone(tmp_path):
    """A source that includes no quoted header hashes its own bytes (and
    the flags) only, and a missing quoted include is not followed."""
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "absent.cuh"\n')
    assert build.with_headers([src]) == [src.resolve()]
