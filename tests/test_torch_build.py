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
    assert [f.name for f in _build.sources("ssd_scan")] == [
        "ssd_scan.cu", "hopper.cuh"]


def test_editing_a_header_changes_the_digest_of_its_includers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build.source_digest(n, csrc) for n in SOURCES}
    assert before == {n: _build.source_digest(n) for n in SOURCES}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.source_digest(n, csrc) for n in SOURCES}
    changed = {n for n in SOURCES if after[n] != before[n]}
    assert changed == set(SOURCES)


def test_an_edited_build_is_a_copy_named_by_its_text(tmp_path, monkeypatch):
    """``build(name, edit)`` writes the edited text under ``BUILD_DIR``,
    named by a hash of it and of the real source, and never touches the
    real library's name; the compiler is stubbed out."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise LookupError("not compiled here")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    real = (_build.CSRC / "ssd_scan.cu").read_text()
    for mark in ("// a", "// b"):
        try:
            _build.build("ssd_scan", lambda text, m=mark: text + m)
        except LookupError:
            pass
    copies = sorted(tmp_path.glob("ssd_scan-edited-*.cu"))
    assert len(copies) == 2
    assert {c.read_text() for c in copies} == {real + "// a", real + "// b"}
    assert all(_build.source_digest("ssd_scan") not in c.name
               for c in copies)
    assert not list(tmp_path.glob("libssd_scan-*"))
