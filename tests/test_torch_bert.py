"""The port's BERT trunk (``metrics_tpu_torch/nets/bert_encoder.py``) against
the JAX package's ``FlaxBertModel`` at a small config (2 layers, 64 wide,
4 heads), on the CPU, with weights carried both ways: JAX's variables
through ``load_jax_variables``, and a seeded HF-keyed torch state dict into
the port as it is and into JAX through JAX's ``load_bert_torch_state_dict``.
HF's ``transformers.BertModel`` is a third witness where it is installed.

Tolerance: every hidden state within 1e-5 relative of the reference, with
an absolute floor of 1e-5 of the state's largest magnitude (layer norms
and softmax in float32, their sums in another order; measured up to 4e-7
of the largest magnitude).
"""
import warnings
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from metrics_tpu.functional.text import bert_score as j_bert_score  # noqa: E402
from metrics_tpu.nets import bert_encoder as jbe  # noqa: E402
from metrics_tpu_torch.functional.text import bert_score as t_bert_score  # noqa: E402
from metrics_tpu_torch.nets import bert_encoder as tbe  # noqa: E402

CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128, max_position_embeddings=64)
RTOL = 1e-5
CLS, SEP = 101, 102


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()), err_msg=what)


def _batch(seed, n=4, length=12):
    """Ids with [CLS]/[SEP] and padded rows (three lengths, one full)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 100, (n, length)).astype(np.int32)
    lens = [length, 7, 3, 10][:n]
    mask = (np.arange(length)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    ids[:, 0] = CLS
    for r, k in enumerate(lens):
        ids[r, k - 1] = SEP
    return ids * mask, mask


def tokenizer(texts, max_length):
    """Hash WordPiece stand-in: [CLS] words [SEP], padded to the longest."""
    rows = [[CLS] + [3 + zlib.crc32(w.encode()) % 98 for w in t.split()][: max_length - 2] + [SEP] for t in texts]
    length = max(len(r) for r in rows)
    ids = np.zeros((len(rows), length), np.int32)
    mask = np.zeros((len(rows), length), np.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    return ids, mask


@pytest.fixture(scope="module")
def jax_model():
    module = jbe.FlaxBertModel(jbe.BertConfigLite(**CFG))
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8)))
    return module, variables, jax.jit(module.apply)


def _port(**kw):
    net = tbe.FlaxBertModel(tbe.BertConfigLite(**CFG))
    tbe.seeded_bert_init(net, kw.get("seed", 0))
    return net.eval()


def _hf_state_dict(seed):
    """A seeded state dict keyed as HF's ``BertForMaskedLM`` (``bert.``
    prefix, a pooler, a ``cls`` head, the position-id buffer)."""
    net = _port(seed=seed)
    state = {f"bert.{k}": v.clone() for k, v in net.state_dict().items()}
    h = CFG["hidden_size"]
    state["bert.embeddings.position_ids"] = torch.arange(CFG["max_position_embeddings"])[None, :]
    state["bert.pooler.dense.weight"] = torch.zeros(h, h)
    state["bert.pooler.dense.bias"] = torch.zeros(h)
    state["cls.predictions.bias"] = torch.zeros(CFG["vocab_size"])
    return state


def test_trunk_with_jax_variables_matches_jax(jax_model):
    module, variables, apply = jax_model
    net = tbe.load_jax_variables(_port(), jax.tree_util.tree_map(np.asarray, variables))
    ids, mask = _batch(1)
    want = apply(variables, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = net(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(got) == len(want) == CFG["num_hidden_layers"] + 1
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"hidden state {i}")
    # a token type of ones takes the second type embedding in both
    tt = np.ones_like(ids)
    with torch.no_grad():
        got = net(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(tt))
    want = apply(variables, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(tt))
    _close(got[-1], want[-1], "token type 1")


def test_trunk_with_an_hf_state_dict_matches_jax(jax_model):
    """The same HF-keyed state dict into the port as it is and into JAX
    through JAX's loader: every hidden state, padded rows included."""
    module, variables, apply = jax_model
    state = _hf_state_dict(seed=5)
    net = tbe.load_bert_torch_state_dict(_port(seed=9), state)
    for key, value in net.state_dict().items():
        assert torch.equal(value, state[f"bert.{key}"]), key
    j_vars = jbe.load_bert_torch_state_dict(variables, state)
    ids, mask = _batch(2)
    want = apply(j_vars, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = net(torch.from_numpy(ids), torch.from_numpy(mask))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"hidden state {i}")
    # the plain HF keys load with load_state_dict as they are
    plain = _port(seed=11)
    plain.load_state_dict({k[5:]: v for k, v in state.items() if not k.startswith(("bert.pooler", "cls.")) and not k.endswith("position_ids")})
    for key, value in plain.state_dict().items():
        assert torch.equal(value, net.state_dict()[key])


@pytest.mark.parametrize("layer", [0, 1, 2, -1, -3])
def test_encoder_emits_each_hidden_state(jax_model, layer):
    """``BertEncoder(layer=)`` picks one hidden state (the trunk runs only
    up to it), as JAX's encoder does with the same weights."""
    _, variables, _ = jax_model
    state = _hf_state_dict(seed=7)
    texts = ["the cat sat on the mat", "a dog", "hello world again and again"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t_enc = tbe.BertEncoder(tokenizer, weights=state, cfg=tbe.BertConfigLite(**CFG), layer=layer, device="cpu")
        j_enc = jbe.BertEncoder(tokenizer, weights=state, cfg=jbe.BertConfigLite(**CFG), layer=layer)
    emb, mask, ids = t_enc(texts)
    j_emb, j_mask, j_ids = j_enc(texts)
    assert emb.dtype == torch.float32 and mask.dtype == ids.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    _close(emb, j_emb, f"layer {layer}")
    assert t_enc.calibrated


def test_bert_score_through_the_encoders_matches_jax():
    state = _hf_state_dict(seed=13)
    rng = np.random.default_rng(3)
    words = "the cat dog sat on mat hello world a an is it".split()
    preds = [" ".join(rng.choice(words, rng.integers(1, 12))) for _ in range(10)]
    target = [" ".join(rng.choice(words, rng.integers(1, 12))) for _ in range(10)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t_enc = tbe.BertEncoder(tokenizer, weights=state, cfg=tbe.BertConfigLite(**CFG), device="cpu")
        j_enc = jbe.BertEncoder(tokenizer, weights=state, cfg=jbe.BertConfigLite(**CFG))
    for kw in ({}, {"idf": True}):
        got = t_bert_score(preds, target, encoder=t_enc, device="cpu", **kw)
        want = j_bert_score(preds, target, encoder=j_enc, **kw)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=RTOL)


def test_loaders_refuse_unknown_keys_and_shapes(jax_model):
    _, variables, _ = jax_model
    state = _hf_state_dict(seed=1)
    with pytest.raises(KeyError, match="encoder.layer.0.attention.self.gate.weight"):
        tbe.load_bert_torch_state_dict(_port(), {**state, "bert.encoder.layer.0.attention.self.gate.weight": torch.zeros(2)})
    bad = dict(state)
    bad["bert.encoder.layer.1.output.dense.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="encoder.layer.1.output.dense.weight"):
        tbe.load_bert_torch_state_dict(_port(), bad)
    params = jax.tree_util.tree_map(np.asarray, variables)["params"]
    odd = {**params, "embeddings": {**params["embeddings"], "LayerNorm": {**params["embeddings"]["LayerNorm"], "gain": np.ones(64, np.float32)}}}
    with pytest.raises(KeyError, match="gain"):
        tbe.load_jax_variables(_port(), {"params": odd})
    with pytest.raises(ValueError, match="tokenizer"):
        tbe.BertEncoder("not callable", cfg=tbe.BertConfigLite(**CFG), device="cpu")
    with pytest.raises(ValueError, match="layer"):
        tbe.BertEncoder(tokenizer, cfg=tbe.BertConfigLite(**CFG), layer=3, device="cpu")


def test_seeded_init_warns_and_does_not_collapse():
    """Without weights the trunk is a seeded init that warns; its token
    states are not all parallel (a collapsed net would score every pair
    about 1)."""
    with pytest.warns(UserWarning, match="without pretrained weights"):
        enc = tbe.BertEncoder(tokenizer, cfg=tbe.BertConfigLite(**CFG), seed=3, device="cpu")
    assert not enc.calibrated
    emb, mask, _ = enc(["the cat sat on the mat today", "hello world a dog is it"])
    rows = torch.nn.functional.normalize(emb[mask.bool()], dim=-1)
    cos = rows @ rows.T
    off = cos[~torch.eye(cos.shape[0], dtype=torch.bool)]
    assert float(off.mean()) < 0.5
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        twin = tbe.BertEncoder(tokenizer, cfg=tbe.BertConfigLite(**CFG), seed=3, device="cpu")
    for a, b in zip(enc.module.state_dict().values(), twin.module.state_dict().values()):
        assert torch.equal(a, b)


def test_transformers_bert_model_is_a_third_witness():
    """HF's ``BertModel`` with the same weights: every hidden state, on
    unpadded and padded rows (HF's masked-key bias is the dtype's minimum,
    JAX's and the port's -1e9: the rows agree)."""
    transformers = pytest.importorskip("transformers")
    config = transformers.BertConfig(type_vocab_size=2, attn_implementation="eager", **CFG)
    hf = transformers.BertModel(config).eval()
    net = tbe.load_bert_torch_state_dict(_port(), hf.state_dict())
    ids, mask = _batch(4)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long(), output_hidden_states=True).hidden_states
        got = net(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w.numpy(), f"hidden state {i}")
