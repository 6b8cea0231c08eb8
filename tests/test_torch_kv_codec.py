"""ray_torch.serve.llm.kv_codec against ray_tpu.serve.llm.kv_codec, and the
port's KVTierStore with a codec against the reference's, on the CPU.

The port has no ``ml_dtypes``: it carries a bf16 page as its 16-bit words
tagged ``"bfloat16"``. For the same page values (numpy-seeded; the
reference's bf16 arrays are ``ml_dtypes.bfloat16``, the port's their
words), every payload the port encodes must equal the reference's byte for
byte, and each package must decode the other's: fp32, fp16 and bf16, every
mode, unsharded and in two KV-head shards. The store tests mirror the
reference's (``tests/test_kv_codec.py``) and run the same operations on
both stores.
"""

import ast
import pathlib
import time

import ml_dtypes
import numpy as np
import pytest

from ray_tpu.serve.llm import kv_codec as rcodec
from ray_tpu.serve.llm import kv_tier as rtier
from ray_torch.serve.llm import kv_codec as tcodec
from ray_torch.serve.llm import kv_tier as ttier
from ray_torch.serve.llm.kv_cache import _chain_digest

ROOT = pathlib.Path(__file__).resolve().parent.parent
DTYPES = {"float32": np.float32, "float16": np.float16,
          "bfloat16": ml_dtypes.bfloat16}


def _pages(dtype: str, n=3, seed=0, shape=(2, 4, 8, 16)):
    """k and v [L, Hkv, n, page, D] as the reference holds them, and as the
    port does (bf16 as uint16 words), plus the port's dtype tag."""
    rng = np.random.default_rng(seed)
    full = shape[:2] + (n,) + shape[2:]
    ref = [(rng.standard_normal(full) * 2.0).astype(DTYPES[dtype])
           for _ in range(2)]
    if dtype == "bfloat16":
        return ref, [a.view(np.uint16) for a in ref], "bfloat16"
    return ref, ref, None


def _bits(a):
    """An array's raw bits, whatever package decoded it."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("mode", tcodec.MODES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_payloads_byte_identical_and_cross_decodable(dtype, mode, shards):
    (rk, rv), (tk, tv), tag = _pages(dtype)
    want = rcodec.encode_pages(rk, rv, mode, shards=shards)
    got = tcodec.encode_pages(tk, tv, mode, shards=shards, dtype=tag)
    assert got == want            # data, scale, sshape, shape, dtype, raw
    for i in range(rk.shape[2]):
        assert tcodec.encode_page(tk[:, :, i:i + 1], mode, dtype=tag) == \
            rcodec.encode_page(rk[:, :, i:i + 1], mode)
    encs = [ek for ek, _ in want]
    for t_arr, r_arr in zip(tcodec.decode_pages(encs),
                            rcodec.decode_pages(encs)):
        np.testing.assert_array_equal(_bits(t_arr), _bits(r_arr))
    for e in encs:
        np.testing.assert_array_equal(_bits(tcodec.decode_page(e)),
                                      _bits(rcodec.decode_page(e)))
    if mode != "int8":
        np.testing.assert_array_equal(
            _bits(np.concatenate(tcodec.decode_pages(encs), axis=2)),
            _bits(rk))


def test_bf16_int8_payload_decodes_like_ml_dtypes():
    """Neither package's encoder quantizes a bf16 page (the reference's
    ``np.issubdtype`` test is False for ``ml_dtypes.bfloat16``), but an
    int8 payload tagged bfloat16 must still decode alike: dequantized in
    fp32, rounded to bf16 to nearest even."""
    rng = np.random.default_rng(3)
    f = (rng.standard_normal((2, 4, 1, 8, 16)) * 5).astype(np.float32)
    enc = dict(rcodec.encode_page(f, "int8"), dtype="bfloat16")
    want = rcodec.decode_page(enc).view(np.uint16)
    np.testing.assert_array_equal(tcodec.decode_page(enc), want)
    np.testing.assert_array_equal(tcodec.decode_pages([enc, enc])[1], want)
    edge = np.array([np.nan, -np.nan, np.inf, -np.inf, 3.4e38, -3.4e38, 0.0,
                     -0.0, 1e-40, -1e-45, 1.00390625, 1.01171875,
                     1.0029296875], np.float32)
    x = np.concatenate([edge, (rng.standard_normal(4096) * 1e3)
                        .astype(np.float32)])
    np.testing.assert_array_equal(tcodec._from_f32(x, "bfloat16"),
                                  x.astype(ml_dtypes.bfloat16)
                                  .view(np.uint16))


def test_int8_error_within_the_group_scale():
    (rk, _), _, _ = _pages("float32", n=2, seed=5)
    enc = tcodec.encode_page(rk[:, :, :1], "int8")
    s = np.frombuffer(enc["scale"], np.float32).reshape(enc["sshape"])
    err = np.abs(tcodec.decode_page(enc) - rk[:, :, :1])
    assert enc["mode"] == "int8"
    assert (err <= s / 127.0 * 0.5 + 1e-6).all()


def test_tag_must_match_the_words():
    with pytest.raises(ValueError, match="cannot hold"):
        tcodec.encode_page(np.zeros((1, 1, 1, 2, 2), np.float32),
                           "lossless", dtype="bfloat16")
    with pytest.raises(ValueError, match="unknown KV codec"):
        tcodec.encode_page(np.zeros((1, 1, 1, 2, 2), np.float32), "zstd")


def test_codec_and_tier_import_no_ml_dtypes():
    """The chip machine has no ml_dtypes: the port's codec and tier name
    it nowhere in their imports."""
    for name in ("kv_codec", "kv_tier"):
        path = ROOT / "ray_torch" / "serve" / "llm" / f"{name}.py"
        tree = ast.parse(path.read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)]
        assert not [m for m in mods
                    if m.split(".")[0] in ("ml_dtypes", "jax", "ray_tpu")]


# ---------------------------------------------------------------------------
# the store with a codec, both packages side by side
# ---------------------------------------------------------------------------


def _blob(n_pages, seed=0):
    """[L, Hkv, n, page, D] fp32 k/v pair + hex chain digests + token
    lengths (the reference test's blob: narrow-range values, so the
    lossless ratio is visibly > 1)."""
    rng = np.random.default_rng(seed)
    shape = (2, 2, n_pages, 4, 8)
    k = (rng.standard_normal(shape) * 1e-2 + 0.5).astype(np.float32)
    v = (rng.standard_normal(shape) * 1e-2 - 0.5).astype(np.float32)
    digest = b"" if seed == 0 else b"seed%d" % seed
    digs = []
    for i in range(n_pages):
        digest = _chain_digest(digest, [seed * 100 + i])
        digs.append(digest.hex())
    return k, v, digs, [(i + 1) * 4 for i in range(n_pages)]


def _stores(**kw):
    d = dict(max_bytes=1 << 20, disk_dir=None, disk_max_bytes=0,
             ttl_s=600.0, page_size=4, codec="lossless")
    d.update(kw)
    return ttier.KVTierStore(**d), rtier.KVTierStore(**d)


_TIMES = ("encode_ms_p50", "decode_ms_p50")


def _same_stats(port, ref):
    """The port's stats equal the reference's on every key the port keeps;
    the reference's others (remote fetch, prefetch hints) stay 0 there."""
    a = {k: v for k, v in port.stats().items() if k not in _TIMES}
    b = ref.stats()
    assert a == {k: b[k] for k in a}
    assert all(b[k] == 0 for k in b.keys() - a.keys() - set(_TIMES))


def test_store_encoded_roundtrip_and_raw_accounting():
    port, ref = _stores()
    k, v, digs, toks = _blob(3)
    try:
        for s in (port, ref):
            assert s.put(k, v, digs, toks) == 3
        st = port.stats()
        assert st["codec"] == "lossless"
        assert st["shm_bytes_raw"] == k.nbytes + v.nbytes
        assert 0 < st["shm_bytes"] < st["shm_bytes_raw"]
        assert st["codec_ratio"] > 1.0 and st["encode_ms_p50"] > 0.0
        t, gk, gv = port.fetch_chain(digs, start=0)
        assert t == 3
        np.testing.assert_array_equal(gk, k)
        np.testing.assert_array_equal(gv, v)
        t, gk, _gv = port.fetch_chain(digs, start=1)
        assert t == 2
        np.testing.assert_array_equal(gk, k[:, :, 1:])
        for s in (ref,):
            s.fetch_chain(digs, start=0)
            s.fetch_chain(digs, start=1)
        _same_stats(port, ref)
    finally:
        port.close()
        ref.close()


def test_store_bf16_words_stored_as_the_reference_stores_bf16():
    (rk, rv), (tk, tv), tag = _pages("bfloat16", n=3, seed=9)
    digs = [_chain_digest(b"", [i]).hex() for i in range(3)]
    toks = [16, 32, 48]
    for codec in ("none", "lossless", "int8"):
        port, ref = _stores(codec=codec, page_size=16)
        port.dtype = tag
        try:
            assert port.put(tk, tv, digs, toks) == 3
            assert ref.put(rk, rv, digs, toks) == 3
            _same_stats(port, ref)
            t, gk, gv = port.fetch_chain(digs, start=0)
            assert t == 3
            np.testing.assert_array_equal(gk.view(np.uint16), tk)
            np.testing.assert_array_equal(gv.view(np.uint16), tv)
        finally:
            port.close()
            ref.close()


def test_store_demotion_moves_raw_accounting(tmp_path):
    k, v, digs, toks = _blob(3, seed=1)
    k2, v2, digs2, toks2 = _blob(3, seed=2)
    stores = _stores(disk_max_bytes=1 << 20)
    try:
        for i, s in enumerate(stores):
            s.disk_dir = str(tmp_path / str(i))
            assert s.put(k, v, digs, toks) == 3
            s.max_bytes = s.stats()["shm_bytes"] + 1
            assert s.put(k2, v2, digs2, toks2) == 3
        port = stores[0]
        st = port.stats()
        assert st["disk_bytes"] > 0
        assert st["disk_bytes_raw"] == k.nbytes + v.nbytes
        assert st["shm_bytes_raw"] == k2.nbytes + v2.nbytes
        t, gk, _gv = port.fetch_chain(digs, start=0)
        assert t == 3
        np.testing.assert_array_equal(gk, k)
        stores[1].fetch_chain(digs, start=0)
        _same_stats(*stores)
    finally:
        for s in stores:
            s.close()


def _drain(stream, timeout=30.0):
    got = []
    deadline = time.monotonic() + timeout
    while not stream.exhausted:
        pairs, _wire, _dec = stream.take()
        got.extend(pairs)
        if not pairs:
            assert time.monotonic() < deadline, "stream stalled"
            time.sleep(0.005)
    return got


def test_stream_chunked_restore_bit_exact():
    port, ref = _stores()
    k, v, digs, toks = _blob(6, seed=4)
    try:
        for s in (port, ref):
            assert s.put(k, v, digs, toks) == 6
        streams = [s.open_stream(digs, 0, chunk_pages=2)
                   for s in (port, ref)]
        got = [_drain(st) for st in streams]
        stream = streams[0]
        assert stream.planned == 6 and stream.landed == 6
        assert not stream.failed
        assert stream.wire_bytes == streams[1].wire_bytes \
            < k.nbytes + v.nbytes
        np.testing.assert_array_equal(
            np.concatenate([p[0] for p in got[0]], axis=2), k)
        np.testing.assert_array_equal(
            np.concatenate([p[1] for p in got[0]], axis=2), v)
        assert port.stats()["streams"] == 0
        _same_stats(port, ref)
    finally:
        port.close()
        ref.close()


def test_stream_chunk_fault_yields_partial():
    port, ref = _stores()
    k, v, digs, toks = _blob(6, seed=6)

    def fault(ci):
        if ci >= 1:
            raise RuntimeError("injected chunk fault")

    try:
        for s in (port, ref):
            assert s.put(k, v, digs, toks) == 6
            s._chunk_fault = fault
        got = {}
        for name, s in (("port", port), ("ref", ref)):
            stream = s.open_stream(digs, 0, chunk_pages=2)
            got[name] = _drain(stream)
            assert stream.failed and stream.planned == 6
        assert len(got["port"]) == len(got["ref"]) == 2
        np.testing.assert_array_equal(
            np.concatenate([p[0] for p in got["port"]], axis=2),
            k[:, :, :2])
        _same_stats(port, ref)
    finally:
        port.close()
        ref.close()
