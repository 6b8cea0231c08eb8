"""KV page codec: the port's copy of ``ray_tpu/serve/llm/kv_codec.py``.

The KV tier (``kv_tier.py``) stores evicted pool pages encoded, one payload
per [L, Hkv, 1, page, D] page slice, so a chunked restore decodes exactly
the pages that landed:

- ``lossless`` (the engine default): byte-plane shuffle + DEFLATE. Every
  element's Nth byte is grouped with the others' Nth bytes, which puts the
  low-entropy sign/exponent bytes of floating KV in runs a generic entropy
  coder can use. Bit-exact, so greedy tokens after a restore equal a cold
  prefill's;
- ``int8``: per-(layer, kv-head) symmetric scale quantization to int8, then
  DEFLATE. Reconstruction error is bounded per element by ``scale / 127``
  of its group. Only float pages are quantized; any other page is stored
  ``lossless``;
- ``none``: the raw bytes.

bfloat16 without ``ml_dtypes``. numpy has no bfloat16, and torch cannot
hand a bf16 tensor to numpy, so the port carries a bf16 page on the host as
its raw 16-bit words (``tensor.view(torch.int16).numpy()``) and names the
dtype separately: the ``dtype`` argument of the encoders, which goes into
the payload's ``"dtype"`` tag as the reference writes it (``"bfloat16"``).
Decoding a ``"bfloat16"`` payload returns ``uint16`` words. The tag, never
the array's dtype, decides what a page is. The reference decides whether
to quantize with ``np.issubdtype(dtype, np.floating)``, which is False for
``ml_dtypes.bfloat16``: its ``int8`` mode stores a bf16 page ``lossless``.
The port keeps that rule (``_quantizable``), so for the same page values
every payload it encodes is byte-identical to the reference's (``data``,
``scale``, ``shape``, ``dtype``, ``raw``), and each package decodes the
other's, an ``int8`` payload tagged ``"bfloat16"`` included (dequantized in
fp32 and rounded to bf16 to nearest even, as ``ml_dtypes``' ``astype``).

The batch entry points (:func:`encode_pages` / :func:`decode_pages`) keep
the per-page payload contract but run the relayout, cast, quantization and
byte-plane transpose once over the whole batch; only DEFLATE runs per page.
``encode_pages(..., shards=N)`` splits every page along the KV-head axis
into N independently encoded sub-payloads (``mode="shards"``), as the
reference's tensor-parallel spill does.

Everything here is host-side numpy + zlib: no device work, no locks.
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

MODES = ("none", "lossless", "int8")

# DEFLATE effort. Level 1 is ~5x faster than the default 6 and within a
# few percent of its ratio on byte-plane-shuffled KV: the shuffle, not the
# match search, is what exposes the redundancy.
_ZLEVEL = 1

BF16 = "bfloat16"


def _dtype(name: str) -> np.dtype:
    """The numpy dtype a page tagged ``name`` is held in on the host:
    bfloat16 pages as ``uint16`` words."""
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


def _tag(a: np.ndarray, dtype: Optional[str]) -> str:
    """The payload's dtype tag for host array ``a``: ``dtype`` when given
    (``"bfloat16"`` for an array of 16-bit words), else the array's."""
    if dtype is None or dtype == str(a.dtype):
        return str(a.dtype)
    if dtype != BF16 or a.dtype.kind not in "iu" or a.dtype.itemsize != 2:
        raise ValueError(f"a {a.dtype} array cannot hold {dtype} pages")
    return BF16


def _quantizable(tag: str) -> bool:
    """Whether ``int8`` quantizes a page of this dtype: numpy's floating
    types only, which leaves bfloat16 out, as the reference's
    ``np.issubdtype`` test does for ``ml_dtypes.bfloat16``."""
    return tag != BF16 and np.issubdtype(np.dtype(tag), np.floating)


def _to_f32(a: np.ndarray, tag: str) -> np.ndarray:
    if tag == BF16:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _from_f32(x: np.ndarray, tag: str) -> np.ndarray:
    """fp32 values as a ``tag`` array; bfloat16 as words rounded to
    nearest even (NaN kept a quiet NaN of its sign), as ``ml_dtypes``."""
    if tag != BF16:
        return x.astype(tag)
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    words = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        words[nan] = ((u[nan] >> 16) | 0x40).astype(np.uint16)
    return words


def _planes(a: np.ndarray) -> bytes:
    """Byte-plane shuffle: element-major bytes -> plane-major bytes."""
    buf = np.frombuffer(a.tobytes(), np.uint8)
    return np.ascontiguousarray(
        buf.reshape(-1, a.dtype.itemsize).T).tobytes()


def _unplanes(data: bytes, dt: np.dtype) -> bytes:
    planes = np.frombuffer(data, np.uint8).reshape(dt.itemsize, -1)
    return np.ascontiguousarray(planes.T).tobytes()


def encode_page(arr: np.ndarray, mode: str,
                dtype: Optional[str] = None) -> dict:
    """Encode one page array. Returns a self-describing dict payload:
    ``mode``, ``data`` (compressed bytes), ``shape``, ``dtype`` (the tag),
    ``raw`` (original nbytes), and for int8 the per-group ``scale`` bytes
    and ``sshape``. ``dtype="bfloat16"`` marks ``arr`` as bf16 words."""
    if mode not in MODES:
        raise ValueError(f"unknown KV codec mode {mode!r}")
    a = np.ascontiguousarray(arr)
    tag = _tag(a, dtype)
    base = {"shape": tuple(a.shape), "dtype": tag, "raw": int(a.nbytes)}
    if mode == "int8" and _quantizable(tag):
        f = _to_f32(a, tag)
        # one symmetric scale per (layer, kv-head) group
        red = tuple(range(2, f.ndim)) if f.ndim > 2 \
            else tuple(range(f.ndim))
        s = np.max(np.abs(f), axis=red, keepdims=True)
        s = np.where(s == 0.0, 1.0, s).astype(np.float32)
        q = np.clip(np.rint(f / s * 127.0), -127, 127).astype(np.int8)
        return {**base, "mode": "int8",
                "data": zlib.compress(q.tobytes(), _ZLEVEL),
                "scale": s.tobytes(), "sshape": tuple(s.shape)}
    if mode == "int8":
        mode = "lossless"   # not quantized: see _quantizable
    if mode == "lossless":
        return {**base, "mode": "lossless",
                "data": zlib.compress(_planes(a), _ZLEVEL)}
    return {**base, "mode": "none", "data": a.tobytes()}


def decode_page(enc: dict) -> np.ndarray:
    """Invert :func:`encode_page`. Bit-exact for none/lossless; int8
    reconstructs within ``scale/127`` per element. A ``"shards"`` payload
    reassembles the full page along the KV-head axis."""
    mode = enc["mode"]
    if mode == "shards":
        return np.concatenate(
            [decode_page(s) for s in enc["shards"]], axis=1)
    dt = _dtype(enc["dtype"])
    shape = tuple(enc["shape"])
    if mode == "none":
        return np.frombuffer(enc["data"], dt).reshape(shape)
    if mode == "lossless":
        return np.frombuffer(
            _unplanes(zlib.decompress(enc["data"]), dt), dt).reshape(shape)
    if mode == "int8":
        q = np.frombuffer(zlib.decompress(enc["data"]),
                          np.int8).reshape(shape)
        s = np.frombuffer(enc["scale"], np.float32).reshape(enc["sshape"])
        return _from_f32(q.astype(np.float32) * (s / 127.0), enc["dtype"])
    raise ValueError(f"unknown KV codec mode {mode!r}")


def encoded_nbytes(enc: dict) -> int:
    """Stored footprint of one encoded page payload."""
    if enc.get("mode") == "shards":
        return sum(encoded_nbytes(s) for s in enc["shards"])
    return len(enc["data"]) + len(enc.get("scale") or b"")


# ---------------------------------------------------------------------------
# batch entry points: vectorized twins of encode/decode_page
# ---------------------------------------------------------------------------


def _encode_batch(a: np.ndarray, mode: str, tag: str) -> list[dict]:
    """Encode every page of ``a`` ([L, Hkv, n, page, D]): payloads
    byte-identical to ``encode_page(a[:, :, i:i+1], mode)`` per page, with
    the relayout / cast / quant / byte-plane shuffle run once."""
    n = a.shape[2]
    # page-major contiguous copy: pm[i] holds the bytes of a[:, :, i:i+1]
    pm = np.ascontiguousarray(np.moveaxis(a, 2, 0))     # [n, L, Hkv, pg, D]
    page_shape = (a.shape[0], a.shape[1], 1) + a.shape[3:]
    base = {"shape": page_shape, "dtype": tag, "raw": int(a.nbytes // n)}
    if mode == "int8" and _quantizable(tag):
        f = _to_f32(pm, tag)
        # encode_page's (layer, kv-head) groups: (page, D) per batch entry
        s = np.max(np.abs(f), axis=(3, 4), keepdims=True)  # [n,L,Hkv,1,1]
        s = np.where(s == 0.0, 1.0, s).astype(np.float32)
        q = np.clip(np.rint(f / s * 127.0), -127, 127).astype(np.int8)
        sshape = (a.shape[0], a.shape[1], 1, 1, 1)
        return [{**base, "mode": "int8",
                 "data": zlib.compress(q[i], _ZLEVEL),
                 "scale": s[i].tobytes(), "sshape": sshape}
                for i in range(n)]
    if mode == "int8":
        mode = "lossless"   # not quantized: see _quantizable
    if mode == "lossless":
        # one byte-plane transpose for the whole batch; per-page slices of
        # the result are the exact _planes() bytes of that page
        itemsize = a.dtype.itemsize
        buf = pm.view(np.uint8).reshape(n, -1, itemsize)
        planes = np.ascontiguousarray(buf.transpose(0, 2, 1))
        return [{**base, "mode": "lossless",
                 "data": zlib.compress(planes[i], _ZLEVEL)}
                for i in range(n)]
    return [{**base, "mode": "none", "data": pm[i].tobytes()}
            for i in range(n)]


def _shard_wrap(per_shard: list[list[dict]], full_shape, tag: str,
                raw: int) -> list[dict]:
    """Zip per-shard payload lists into one ``mode="shards"`` payload per
    page: ``per_shard[s][i]`` is shard s of page i."""
    n = len(per_shard[0])
    return [{"mode": "shards", "shape": tuple(full_shape),
             "dtype": tag, "raw": int(raw),
             "shards": [ps[i] for ps in per_shard]}
            for i in range(n)]


def encode_pages(k_np: np.ndarray, v_np: np.ndarray, mode: str,
                 shards: int = 1,
                 dtype: Optional[str] = None) -> list[tuple[dict, dict]]:
    """Batch-encode a spilled chain: k_np/v_np are [L, Hkv, n, page, D]
    (bf16 as words, with ``dtype="bfloat16"``); returns ``[(ek, ev), ...]``
    of length n, each payload byte-identical to the per-page
    :func:`encode_page` of that page slice. ``shards > 1`` splits the
    KV-head axis into that many sub-payloads inside one page payload."""
    if mode not in MODES:
        raise ValueError(f"unknown KV codec mode {mode!r}")
    k = np.ascontiguousarray(k_np)
    v = np.ascontiguousarray(v_np)
    tag = _tag(k, dtype)
    if _tag(v, dtype) != tag:
        raise ValueError(f"k is {k.dtype}, v is {v.dtype}")
    if shards <= 1:
        return list(zip(_encode_batch(k, mode, tag),
                        _encode_batch(v, mode, tag)))
    if k.shape[1] % shards != 0:
        raise ValueError(
            f"{k.shape[1]} KV heads not divisible by {shards} shards")
    h = k.shape[1] // shards
    page_shape = (k.shape[0], k.shape[1], 1) + k.shape[3:]
    raw = k.nbytes // k.shape[2]
    ks = _shard_wrap(
        [_encode_batch(np.ascontiguousarray(
            k[:, s * h:(s + 1) * h]), mode, tag) for s in range(shards)],
        page_shape, tag, raw)
    vs = _shard_wrap(
        [_encode_batch(np.ascontiguousarray(
            v[:, s * h:(s + 1) * h]), mode, tag) for s in range(shards)],
        page_shape, tag, raw)
    return list(zip(ks, vs))


def decode_pages(encs: list[dict]) -> list[np.ndarray]:
    """Invert a batch of :func:`encode_page` payloads: the same arrays as
    ``[decode_page(e) for e in encs]``, with the un-shuffle / dequant
    vectorized across the batch when the payloads are homogeneous (a mixed
    batch falls back to the per-page path)."""
    if not encs:
        return []
    first = encs[0]
    if first.get("mode") == "shards":
        if all(e.get("mode") == "shards"
               and len(e["shards"]) == len(first["shards"])
               for e in encs):
            parts = [decode_pages([e["shards"][s] for e in encs])
                     for s in range(len(first["shards"]))]
            return [np.concatenate([p[i] for p in parts], axis=1)
                    for i in range(len(encs))]
        return [decode_page(e) for e in encs]
    homogeneous = all(
        e["mode"] == first["mode"] and e["dtype"] == first["dtype"]
        and tuple(e["shape"]) == tuple(first["shape"])
        and tuple(e.get("sshape") or ()) == tuple(first.get("sshape") or ())
        for e in encs)
    if not homogeneous or first["mode"] == "none":
        return [decode_page(e) for e in encs]
    n = len(encs)
    dt = _dtype(first["dtype"])
    shape = tuple(first["shape"])
    if first["mode"] == "lossless":
        elems = int(np.prod(shape))
        # un-shuffle by strided write straight into the output buffer,
        # then one zero-copy dtype view
        flat = np.empty((n, elems, dt.itemsize), np.uint8)
        for i, e in enumerate(encs):
            flat[i] = np.frombuffer(
                zlib.decompress(e["data"]), np.uint8).reshape(
                dt.itemsize, elems).T
        out = flat.reshape(n, elems * dt.itemsize).view(dt).reshape(
            (n,) + shape)
        return [out[i] for i in range(n)]
    if first["mode"] == "int8":
        q = np.empty((n,) + shape, np.int8)
        s = np.empty((n,) + tuple(first["sshape"]), np.float32)
        for i, e in enumerate(encs):
            q[i] = np.frombuffer(zlib.decompress(e["data"]),
                                 np.int8).reshape(shape)
            s[i] = np.frombuffer(e["scale"], np.float32).reshape(
                e["sshape"])
        # one vectorized dequant across the (layer, kv-head) grid
        out = _from_f32(q.astype(np.float32) * (s / 127.0), first["dtype"])
        return [out[i] for i in range(n)]
    return [decode_page(e) for e in encs]
