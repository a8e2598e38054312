"""Native adapter trimmer (native/trim/; SURVEY.md §2 row 17): library
semantics + the standalone pipe-filter binary."""

import os
import subprocess

import pytest

wn = pytest.importorskip("irfinder_tpu.native.trim_native")


@pytest.fixture(scope="module")
def lib():
    try:
        return wn.load_library()
    except Exception as e:  # no toolchain
        pytest.skip(f"native build unavailable: {e}")


AD1 = wn.ADAPTER_R1
AD2 = wn.ADAPTER_R2


def test_no_adapter_keeps_read(lib):
    read = b"ACGTACGTACGTACGTACGTACGTACGTACGT"
    assert wn.trim1(read) == len(read)


def test_full_adapter_at_position(lib):
    insert = b"ACGTTGCAACGTTGCAACGTTGCA"
    read = insert + AD1[:30]
    assert wn.trim1(read) == len(insert)


def test_partial_adapter_suffix(lib):
    insert = b"ACGTTGCAACGTTGCAACGTTGCAGGA"
    read = insert + AD1[:6]  # 6-base adapter prefix at the 3' end
    assert wn.trim1(read) == len(insert)


def test_adapter_with_one_mismatch(lib):
    insert = b"CCCTTTGGGAAACCCTTTGGGAAA"
    ad = bytearray(AD1[:16])
    ad[5] ^= 6  # one sequencing error inside the adapter
    read = insert + bytes(ad)
    assert wn.trim1(read) == len(insert)


def test_short_chance_overlap_kept(lib):
    # a 1-3 base "adapter" suffix match must NOT trim
    read = b"ACGTACGTACGTACGTACGTACGTACGT" + AD1[:2]
    assert wn.trim1(read) == len(read)


def _rc(s: bytes) -> bytes:
    comp = {65: 84, 84: 65, 67: 71, 71: 67}
    return bytes(comp.get(b, 78) for b in reversed(s))


def test_pair_readthrough_clips_to_fragment(lib):
    # fragment shorter than read length: both mates read through into adapter
    frag = b"ACGTTTGCACCAGGTTACGATCCGTAGGCATCAAT"  # 35 bp fragment
    r1 = frag + AD1[: 50 - len(frag)]
    r2 = _rc(frag) + AD2[: 50 - len(frag)]
    k1, k2 = wn.trim_pair(r1, r2)
    assert k1 == len(frag)
    assert k2 == len(frag)


def test_pair_no_overlap_untouched(lib):
    r1 = b"ACGTTGCAACGGAACCTTGGAACCTTGGACGTTGCA"
    r2 = b"TTGGCCAATTGGCCAACCGGTTAACCGGTTACCGGA"
    k1, k2 = wn.trim_pair(r1, r2)
    assert (k1, k2) == (len(r1), len(r2))


def test_filter_binary_four_files(lib, tmp_path):
    from irfinder_tpu.native import _NATIVE_ROOT

    exe = os.path.join(_NATIVE_ROOT, "trim", "trim")
    subprocess.run(["make", "-C", os.path.dirname(exe)], check=True, capture_output=True)
    insert = b"AACCCTAAGGGTTTACAGGGATTTCCCAGGGAAATT"
    r1seq = insert + AD1[:10]
    r2seq = insert  # no adapter
    (tmp_path / "r1.fq").write_bytes(b"@p1\n" + r1seq + b"\n+\n" + b"I" * len(r1seq) + b"\n")
    (tmp_path / "r2.fq").write_bytes(b"@p1\n" + r2seq + b"\n+\n" + b"I" * len(r2seq) + b"\n")
    subprocess.run(
        [exe, str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"),
         str(tmp_path / "o1.fq"), str(tmp_path / "o2.fq")],
        check=True,
    )
    o1 = (tmp_path / "o1.fq").read_bytes().split(b"\n")
    o2 = (tmp_path / "o2.fq").read_bytes().split(b"\n")
    assert o1[1] == insert and len(o1[3]) == len(insert)
    assert o2[1] == r2seq


def test_trim_binary_rebuilt_when_missing(tmp_path, monkeypatch):
    """The standalone trim binary is a build output (not tracked): when it
    is missing but libtrim.so is present, ensure_built must rebuild it."""
    import shutil

    import irfinder_tpu.native as N

    src = os.path.join(N._NATIVE_ROOT, "trim")
    dst = tmp_path / "native" / "trim"
    dst.mkdir(parents=True)
    for f in ("Makefile", "trim.cpp"):
        shutil.copy(os.path.join(src, f), dst / f)
    monkeypatch.setattr(N, "_NATIVE_ROOT", str(tmp_path / "native"))
    N.ensure_built("trim", "libtrim.so", also=("trim",))
    assert (dst / "libtrim.so").exists() and (dst / "trim").exists()
    (dst / "trim").unlink()
    N.ensure_built("trim", "libtrim.so", also=("trim",))
    assert (dst / "trim").exists()
