"""The kernel build's content hash (``repro_torch.kernels._build``) on the
CPU: a library's name covers its source and every header the source
includes, so an edited header rebuilds and a stale library is never loaded.
Nothing here compiles."""
import shutil

from repro_torch.kernels import _build

SOURCES = ("flash_attention", "gemm_epilogue", "ssd_scan", "streamed_gemm")


def test_sources_follow_the_includes():
    assert [f.name for f in _build.sources("flash_attention")] == [
        "flash_attention.cu", "hopper.cuh"]
    assert [f.name for f in _build.sources("gemm_epilogue")] == [
        "gemm_epilogue.cu", "hopper.cuh"]
    assert [f.name for f in _build.sources("streamed_gemm")] == [
        "streamed_gemm.cu", "hopper.cuh"]
    assert [f.name for f in _build.sources("ssd_scan")] == ["ssd_scan.cu"]


def test_editing_a_header_changes_the_digest_of_its_includers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build.source_digest(n, csrc) for n in SOURCES}
    assert before == {n: _build.source_digest(n) for n in SOURCES}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.source_digest(n, csrc) for n in SOURCES}
    changed = {n for n in SOURCES if after[n] != before[n]}
    assert changed == {"flash_attention", "gemm_epilogue", "streamed_gemm"}
