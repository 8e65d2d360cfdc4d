"""State ownership (ROADMAP F2): a tensor that the runtime hands out or
takes in is never shared with a live state, so metrics loaded from one
``state_dict`` stay independent and a held ``metric_state`` does not move,
as in the JAX package, whose arrays are immutable. Compute groups of a
collection still share their head's state on purpose.

Each case runs the same steps on the JAX twin; counts exact, AUROC within
``AREA_ATOL`` (float32 sums in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
from metrics_tpu_torch.interop import load_jax_state  # noqa: E402

AREA_ATOL = 1e-6


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return rng.random(n).astype(np.float32), (rng.random(n) < 0.5).astype(np.int32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_two_metrics_loaded_from_one_state_dict_stay_independent():
    p, y = _rows(0, 8)
    src, jsrc = mtt.Accuracy(device="cpu"), mt.Accuracy()
    src.update(torch.from_numpy(p[:4]), torch.from_numpy(y[:4]))
    jsrc.update(jnp.asarray(p[:4]), jnp.asarray(y[:4]))
    src.persistent(True)
    jsrc.persistent(True)
    sd, jsd = src.state_dict(), jsrc.state_dict()
    a, b = mtt.Accuracy(device="cpu"), mtt.Accuracy(device="cpu")
    ja, jb = mt.Accuracy(), mt.Accuracy()
    for m, jm in ((a, ja), (b, jb)):
        m.load_state_dict(sd)
        jm.load_state_dict(jsd)
    a.update(torch.from_numpy(p[4:]), torch.from_numpy(y[4:]))
    ja.update(jnp.asarray(p[4:]), jnp.asarray(y[4:]))
    for m, jm in ((a, ja), (b, jb), (src, jsrc)):
        for k in ("tp", "fp", "tn", "fn"):
            np.testing.assert_array_equal(_np(m.metric_state[k]), np.asarray(jm.metric_state[k]))
    for k, v in sd.items():  # the dict itself is untouched
        np.testing.assert_array_equal(_np(v), np.asarray(jsd[k]))


def test_rings_loaded_from_one_dict_keep_their_own_rows():
    p, y = _rows(1, 18)
    src, jsrc = mtt.AUROC(capacity=32, device="cpu"), mt.AUROC(capacity=32)
    src.update(torch.from_numpy(p[:6]), torch.from_numpy(y[:6]))
    jsrc.update(jnp.asarray(p[:6]), jnp.asarray(y[:6]))
    src.persistent(True)
    jsrc.persistent(True)
    sd, jsd = src.state_dict(), jsrc.state_dict()
    ours = [mtt.AUROC(capacity=32, device="cpu") for _ in range(3)]
    refs = [mt.AUROC(capacity=32) for _ in range(3)]
    for m, jm in zip(ours, refs):
        m.load_state_dict(sd)
        jm.load_state_dict(jsd)
    for i in range(2):
        batch = slice(6 + 6 * i, 12 + 6 * i)
        ours[i].update(torch.from_numpy(p[batch]), torch.from_numpy(y[batch]))
        refs[i].update(jnp.asarray(p[batch]), jnp.asarray(y[batch]))
    for m, jm in zip(ours, refs):
        assert int(m.metric_state["preds"].count()) == int(np.asarray(jm.metric_state["preds"].mask).sum())
        assert abs(float(m.compute()) - float(jm.compute())) <= AREA_ATOL
    assert int(ours[2].metric_state["preds"].count()) == 6
    assert int(torch.as_tensor(sd["preds"]["mask"]).sum()) == 6


def test_a_held_metric_state_does_not_move():
    p, y = _rows(2, 10)
    m, jm = mtt.Accuracy(device="cpu"), mt.Accuracy()
    m.update(torch.from_numpy(p[:5]), torch.from_numpy(y[:5]))
    jm.update(jnp.asarray(p[:5]), jnp.asarray(y[:5]))
    held, jheld = m.metric_state, jm.metric_state
    m.update(torch.from_numpy(p[5:]), torch.from_numpy(y[5:]))
    jm.update(jnp.asarray(p[5:]), jnp.asarray(y[5:]))
    for k in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(_np(held[k]), np.asarray(jheld[k]))
        np.testing.assert_array_equal(_np(m.metric_state[k]), np.asarray(jm.metric_state[k]))

    ring = mtt.AUROC(capacity=16, device="cpu")
    ring.update(torch.from_numpy(p[:5]), torch.from_numpy(y[:5]))
    held_ring = ring.metric_state["preds"]
    ring.update(torch.from_numpy(p[5:]), torch.from_numpy(y[5:]))
    assert int(held_ring.count()) == 5 and int(ring.metric_state["preds"].count()) == 10


def test_a_collection_and_interop_load_copies():
    p, y = _rows(3, 12)
    src = mtt.MetricCollection({"acc": mtt.Accuracy(device="cpu"), "ss": mtt.StatScores(device="cpu")})
    src.update(torch.from_numpy(p[:6]), torch.from_numpy(y[:6]))
    src.persistent(True)
    sd = src.state_dict()
    a = mtt.MetricCollection({"acc": mtt.Accuracy(device="cpu"), "ss": mtt.StatScores(device="cpu")})
    b = mtt.MetricCollection({"acc": mtt.Accuracy(device="cpu"), "ss": mtt.StatScores(device="cpu")})
    a.load_state_dict(sd)
    b.load_state_dict(sd)
    a.update(torch.from_numpy(p[6:]), torch.from_numpy(y[6:]))
    assert int(b["acc"].metric_state["tp"]) == int(sd["acc"]["tp"]) < int(a["acc"].metric_state["tp"])

    jm = mt.Accuracy()
    jm.update(jnp.asarray(p[:6]), jnp.asarray(y[:6]))
    state = {k: np.asarray(v) for k, v in jm.metric_state.items()}
    x, z = mtt.Accuracy(device="cpu"), mtt.Accuracy(device="cpu")
    load_jax_state(x, state)
    load_jax_state(z, state)
    x.update(torch.from_numpy(p[6:]), torch.from_numpy(y[6:]))
    for k, v in state.items():
        np.testing.assert_array_equal(z.metric_state[k].numpy(), v)


def test_compute_groups_still_share_the_head_state():
    p, y = _rows(4, 12)
    coll = mtt.MetricCollection({"acc": mtt.Accuracy(device="cpu"), "ss": mtt.StatScores(device="cpu")})
    coll.update(torch.from_numpy(p[:6]), torch.from_numpy(y[:6]))
    assert coll.compute_groups == {0: ["acc", "ss"]}
    acc = coll.__getitem__("acc", copy_state=False)
    ss = coll.__getitem__("ss", copy_state=False)
    assert all(acc._state[k] is ss._state[k] for k in ("tp", "fp", "tn", "fn"))
    coll.update(torch.from_numpy(p[6:]), torch.from_numpy(y[6:]))
    assert torch.equal(coll.compute()["ss"][:4], torch.stack([acc.tp, acc.fp, acc.tn, acc.fn]))
