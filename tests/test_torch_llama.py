"""ray_torch.models.llama against ray_tpu.models.llama on the CPU.

The same weights (the JAX init, handed over through ``params_from_numpy``)
and the same token arrays (from a numpy seed) go through both forwards.
Tolerance 1e-4 on fp32 logits: the two frameworks sum the same products
in different orders (XLA's dot vs torch's matmul), which moves fp32
logits by ~1e-6; a wrong layout, rotation or mask moves them by O(1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_torch.models import llama as tllama


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _bits(t):
    """A tensor's bit patterns (bf16 as int16), for exact comparison."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _tiny_pair(**kw):
    return jllama.llama_tiny(**kw), tllama.llama_tiny(**kw)


def test_forward_logits_match_jax():
    jcfg, tcfg = _tiny_pair()
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.RandomState(0).randint(0, 256, (2, 24)).astype(
        np.int32)
    tokens[:, 0] = 256  # the byte tokenizer's BOS: past the 256-row table
    want = np.asarray(jllama.forward(params, jnp.asarray(tokens), jcfg))
    tparams = tllama.params_from_numpy(_np_tree(params), "cpu")
    got = tllama.forward(tparams, torch.from_numpy(tokens).long(), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_building_blocks_match_jax():
    """rms_norm (fp32 accumulate), interleaved-pair RoPE, kv-major GQA."""
    jcfg, tcfg = _tiny_pair()
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 4, jcfg.head_dim).astype(np.float32)
    pos = rs.randint(0, 200, (2, 5)).astype(np.int32)
    jc, js = jllama.rope_freqs(jcfg, jnp.asarray(pos))
    tc, ts = tllama.rope_freqs(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    want = jllama.apply_rope(jnp.asarray(x), jc, js)
    got = tllama.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    w = rs.rand(jcfg.head_dim).astype(np.float32)
    np.testing.assert_allclose(
        tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                        1e-5).numpy(),
        np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6)
    kv = rs.randn(2, 5, 2, 8).astype(np.float32)
    np.testing.assert_array_equal(
        tllama._gqa_expand(torch.from_numpy(kv), 3).numpy(),
        np.asarray(jllama._gqa_expand(jnp.asarray(kv), 3)))


def test_param_shapes_and_count_match_jax():
    for jcfg, tcfg in (_tiny_pair(), (jllama.llama3_1b(), tllama.llama3_1b())):
        params = jax.eval_shape(
            lambda c=jcfg: jllama.init_params(jax.random.PRNGKey(0), c))
        want = {k: tuple(v.shape)
                for k, v in tllama.flatten_params(params).items()}
        assert tllama.param_shapes(tcfg) == want
        assert tllama.num_params(tcfg) == jllama.num_params(jcfg)
    # init draws differ from jax.random, but the structure, dtypes and
    # scale follow the reference
    tparams = tllama.init_params(tllama.llama_tiny(),
                                 torch.Generator().manual_seed(0))
    flat = tllama.flatten_params(tparams)
    assert flat["final_norm"].dtype == torch.float32
    assert float(flat["final_norm"].sum()) == 64.0
    assert abs(float(flat["embed"].std()) - 64 ** -0.5) < 0.01


def test_params_from_numpy_bf16_bits_exact():
    """np.asarray of a JAX bf16 array is an ml_dtypes array: the bridge
    reinterprets its 16-bit patterns, so every bit survives."""
    jcfg = jllama.llama_tiny(dtype=jnp.bfloat16)
    params = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = tllama.params_from_numpy(_np_tree(params), "cpu")
    for key, arr in tllama.flatten_params(_np_tree(params)).items():
        t = tllama.flatten_params(tparams)[key]
        if arr.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(t).numpy(),
                                          arr.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), arr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npz_round_trip_both_directions(tmp_path, dtype):
    """A JAX checkpoint loads into the port bit-exactly (bf16 leaves come
    back from the npz as raw |V2), and the port's own save/load round
    trip keeps every leaf's bits and dtype."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jcfg = jllama.llama_tiny(dtype=jdt)
    tcfg = tllama.llama_tiny(dtype=tdt)
    params = jllama.init_params(jax.random.PRNGKey(4), jcfg)
    path = jllama.save_params(params, str(tmp_path / "jax"))
    loaded = tllama.load_params(path, tcfg, "cpu")
    direct = tllama.params_from_numpy(_np_tree(params), "cpu")
    flat_l = tllama.flatten_params(loaded)
    for key, t in tllama.flatten_params(direct).items():
        assert flat_l[key].dtype == t.dtype
        assert torch.equal(_bits(flat_l[key]), _bits(t))
    assert flat_l["embed"].dtype == tdt
    assert flat_l["final_norm"].dtype == torch.float32

    again = tllama.load_params(
        tllama.save_params(loaded, str(tmp_path / "port.npz")), tcfg, "cpu")
    for key, t in tllama.flatten_params(again).items():
        ref = flat_l[key]
        assert t.dtype == ref.dtype
        assert torch.equal(_bits(t), _bits(ref))


def test_load_params_rejects_mismatched_config(tmp_path):
    params = jllama.init_params(jax.random.PRNGKey(0), jllama.llama_tiny())
    path = jllama.save_params(params, str(tmp_path))
    with pytest.raises(ValueError, match="does not match config"):
        tllama.load_params(path, tllama.llama_tiny(dim=128), "cpu")


def test_device_defaults_are_the_card(tmp_path):
    """Loading weights or building a pool without naming a device puts them
    on the card; without a GPU that raises rather than running on the CPU.
    init_params follows its generator."""
    from ray_torch.serve.llm import kv_cache as tkv
    cfg = tllama.llama_tiny()
    tree = {"final_norm": np.ones(64, np.float32)}
    path = tllama.save_params(tllama.params_from_numpy(tree, "cpu"),
                              str(tmp_path / "p.npz"))
    calls = (lambda: tllama.params_from_numpy(tree),
             lambda: tllama.load_params(path),
             lambda: tkv.init_paged_cache(cfg, 2, 8))
    for call in calls:
        if torch.cuda.is_available():
            leaf = tllama.flatten_params(call())
            assert all(t.is_cuda for t in leaf.values())
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    gen = torch.Generator().manual_seed(0)
    flat = tllama.flatten_params(tllama.init_params(cfg, gen))
    assert all(t.device.type == "cpu" for t in flat.values())
