"""The port's GPT-2 and T5 narration towers and their tokenizers against the
JAX package's, on the CPU.

One JAX init of each tiny tower (2 layers, width 32, vocabulary 64) is
carried into the port through ``weights.state_dict_from_jax``'s tower
mapping, then both take the same numpy-seeded ids and padding masks.
Tolerances: f32 outputs within 1e-5 (relative and absolute), bf16 compute
(f32 parameters) within 2^-7 of the output's largest magnitude; parameter
gradients through ``jax.vjp`` against autograd within 1e-5 of each
gradient's largest entry. The relative buckets are exact over -300..300,
and the tokenizers give the same ids as JAX's, on toy GPT-2 and
SentencePiece files written here and on the hash fallbacks. Each tower's
port weights cross back through the reference translator without a new
mapping.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tokenizers import SPM_PIECES, TRICKY, _encode_spm_proto, _toy_gpt2_files
from transfusion_torch import weights as W
from transfusion_torch.models import lm_encoders as T
from transfusion_tpu.models import lm_encoders as J

V, L, B = 64, 12, 3
TOWERS = {
    "gpt2": (dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=4, max_positions=16),),
    "t5_relu": (dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=4, head_dim=8, ff_dim=48),),
    "t5_gated": (dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=4, head_dim=8, ff_dim=48,
                      gated_ff=True),),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 8:] = 0
    mask[2, 3:] = 0
    return ids, mask


def _towers(name, jdt, tdt):
    kw = TOWERS[name][0]
    if name == "gpt2":
        return J.GPT2Encoder(J.GPT2Config(**kw), dtype=jdt), T.GPT2Encoder(T.GPT2Config(**kw), tdt)
    return J.T5Encoder(J.T5Config(**kw), dtype=jdt), T.T5Encoder(T.T5Config(**kw), tdt)


def _pair(name, dtype="f32", out_mode="tokens", out_mlp=24, out_tanh=False, seed=0):
    """(JAX PooledLMEncoder, its params, the port's with the same weights)."""
    jdt, tdt = DTYPES[dtype]
    jtower, ttower = _towers(name, jdt, tdt)
    jmod = J.PooledLMEncoder(jtower, out_mode=out_mode, out_mlp=out_mlp, out_tanh=out_tanh, dtype=jdt)
    ids, mask = _inputs()
    params = jax.device_get(jmod.init(jax.random.key(seed), ids, mask))["params"]
    port = T.PooledLMEncoder(ttower, out_mode, out_mlp, out_tanh, 0.1, tdt)
    port.load_state_dict(_port_state(params), strict=True)
    return jmod, params, port.eval()


def _port_state(narr_params) -> dict:
    """A JAX narr_encoder subtree -> the PooledLMEncoder's state dict, by
    weights.state_dict_from_jax's tower mapping."""
    out: dict = {}
    W._narr_encoder(jax.device_get(narr_params), out)
    return {k.removeprefix("narr_pooling_layer."): torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def _t(x):
    return torch.from_numpy(np.array(x))


def _hold(got, want, dtype, msg=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=msg)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 2 ** -7, (msg, err)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(TOWERS))
def test_tower_matches_jax(name, dtype):
    """Each tower's tokens through out_mlp (and, for T5 under bf16, JAX's
    f32 promotion of the final RMSNorm before the bf16 out_mlp)."""
    jmod, params, port = _pair(name, dtype)
    ids, mask = _inputs()
    want, _ = jmod.apply({"params": params}, ids, mask)
    with torch.no_grad():
        got, got_mask = port(_t(ids).long(), _t(mask))
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    assert str(got.dtype).split(".")[-1] == np.dtype(want.dtype).name
    _hold(got, want, dtype, name)
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    # The tower alone: T5's final RMSNorm gives f32 under bf16 compute.
    jt = jmod.apply({"params": params}, ids, mask, method=lambda m, i, a: m.encoder(i, a))
    with torch.no_grad():
        tt = port.encoder(_t(ids).long(), _t(mask))
    assert str(tt.dtype).split(".")[-1] == np.dtype(jt.dtype).name, (tt.dtype, jt.dtype)
    _hold(tt, jt, dtype, f"{name} tower")


@pytest.mark.parametrize("name", list(TOWERS))
def test_tower_gradients_match_jax(name):
    """f32 parameter gradients of <tokens, cotangent> through jax.vjp and
    through autograd, each within 1e-5 of its largest entry."""
    jmod, params, port = _pair(name)
    ids, mask = _inputs()
    cot = np.random.default_rng(5).normal(0, 1, (B, L, 24)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jmod.apply({"params": p}, ids, mask)[0], params)
    (jgrads,) = vjp(jnp.asarray(cot))
    want = _port_state(jgrads)
    out, _ = port(_t(ids).long(), _t(mask))
    (out * _t(cot)).sum().backward()
    assert set(want) == {k for k, _ in port.named_parameters()}
    for k, v in port.named_parameters():
        w = want[k].numpy()
        g = np.zeros_like(w) if v.grad is None else v.grad.numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        assert np.abs(g - w).max() <= 1e-5 * scale, (k, np.abs(g - w).max(), scale)


def test_relative_buckets_are_exact():
    rel = np.arange(-300, 301)
    for nb, md in ((32, 128), (32, 64), (16, 32)):
        want = np.asarray(J.t5_relative_bucket(jnp.asarray(rel), nb, md))
        got = T.t5_relative_bucket(torch.from_numpy(rel), nb, md).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_mode, out_tanh", [("tokens", True), ("embedding", False), ("embedding", True)])
def test_pooled_encoder_modes_match_jax(out_mode, out_tanh):
    """The masked mean, L2-normalised, through out_mlp and the tanh."""
    jmod, params, port = _pair("t5_gated", out_mode=out_mode, out_tanh=out_tanh)
    ids, mask = _inputs(3)
    want, _ = jmod.apply({"params": params}, ids, mask)
    with torch.no_grad():
        got, _ = port(_t(ids).long(), _t(mask))
    assert got.shape == want.shape
    _hold(got, want, "f32", f"{out_mode} tanh {out_tanh}")


def test_no_out_mlp_when_widths_agree():
    jmod, params, port = _pair("gpt2", out_mlp=32)
    assert port.out_mlp is None and "out_mlp" not in params
    ids, mask = _inputs()
    want, _ = jmod.apply({"params": params}, ids, mask)
    with torch.no_grad():
        _hold(port(_t(ids).long(), _t(mask))[0], want, "f32")


@pytest.mark.parametrize("name", ["gpt2", "t5_gated"])
def test_tower_state_dict_round_trips_through_the_translator(name):
    """The port's tower names are the reference's: translate_reference_
    checkpoint fills JAX's narr_encoder tree from them, every key translated
    and none left over, bit for bit."""
    from transfusion_tpu.tools.translate_checkpoint import translate_reference_checkpoint

    _, params, port = _pair(name)
    sd = {f"narr_pooling_layer.{k}": v for k, v in port.state_dict().items()}
    template = {"narr_encoder": jax.tree.map(np.zeros_like, params)}
    tree, report = translate_reference_checkpoint(sd, template)
    assert not report["unmatched_source"] and not report["missing_target"] and not report["shape_mismatch"]
    assert report["translated"] == len(jax.tree.leaves(params))
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(tree["narr_encoder"])[0])
    for path, want in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(want), err_msg=str(path))


# ------------------------------------------------------------- tokenizers
def test_gpt2_tokenizer_matches_jax(tmp_path):
    from transfusion_torch.data import tokenizer as t_tok
    from transfusion_tpu.data import tokenizer as j_tok

    vj, mg = _toy_gpt2_files(tmp_path)
    ours = t_tok.GPT2BPETokenizer.from_files(vj, mg, max_length=16)
    ref = j_tok.GPT2BPETokenizer.from_files(vj, mg, max_length=16)
    for text in TRICKY:
        assert t_tok.gpt2_words(text) == j_tok.gpt2_words(text), repr(text)
        assert ours.encode(text) == ref.encode(text), repr(text)
    for a, b in zip(ours.encode_batch(TRICKY), ref.encode_batch(TRICKY)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert t_tok.bytes_to_unicode() == j_tok.bytes_to_unicode()


def test_sentencepiece_tokenizer_matches_jax(tmp_path):
    from transfusion_torch.data import tokenizer as t_tok
    from transfusion_tpu.data import tokenizer as j_tok

    path = tmp_path / "spiece.model"
    path.write_bytes(_encode_spm_proto(SPM_PIECES))
    assert t_tok.parse_sentencepiece_model(str(path)) == j_tok.parse_sentencepiece_model(str(path))
    ours = t_tok.SentencePieceTokenizer.from_model_file(str(path), max_length=12)
    ref = j_tok.SentencePieceTokenizer.from_model_file(str(path), max_length=12)
    texts = TRICKY + ["wash the pan", "pat the wash", "wash pans"]
    for text in texts:
        assert ours.tokenize(text) == ref.tokenize(text), repr(text)
    for a, b in zip(ours.encode_batch(texts), ref.encode_batch(texts)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["hash_gpt2_tokenizer", "hash_t5_tokenizer"])
def test_hash_fallback_tokenizers_match_jax(which):
    from transfusion_torch.data import tokenizer as t_tok
    from transfusion_tpu.data import tokenizer as j_tok

    ours, ref = getattr(t_tok, which)(max_length=64), getattr(j_tok, which)(max_length=64)
    assert ours.is_hash_fallback and ref.is_hash_fallback
    texts = TRICKY + ["take knife and cut onion", "put plate on table"]
    for a, b in zip(ours.encode_batch(texts), ref.encode_batch(texts)):
        np.testing.assert_array_equal(a, b)
