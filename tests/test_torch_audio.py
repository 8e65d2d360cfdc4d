"""The audio metric classes of the port (``metrics_tpu_torch/audio/``) against
JAX's, on the same seeded numpy inputs: states after every update and
``forward``, ``compute()``, the captured update against an eager twin, the
host-bound STOI's refused capture, the gated classes through the stand-in
backends, and a four-rank Gloo world against JAX's pure collection under
``jax.vmap(axis_name="data")``.

Tolerances (ROADMAP W6's audio line): ``total`` int32 and exact, as in
JAX; the float32 sums ``atol=1e-4`` dB over a few clips (each clip's value
within ``tests/test_torch_audio_functional.py``'s bound); STOI's sum
``atol=5e-4`` (two clips within 2e-4 each); the Gloo world's synced sums
``atol=1e-4`` of the sum of JAX's shard states.
"""
import multiprocessing as mp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import metrics_tpu as mt  # noqa: E402
import metrics_tpu.functional.audio as J  # noqa: E402
import metrics_tpu_torch as mtt  # noqa: E402
import metrics_tpu_torch.functional.audio as T  # noqa: E402
from metrics_tpu_torch._capture import UpdateGraphs  # noqa: E402
from tests.helpers import torch_audio_ranks as R  # noqa: E402
from tests.helpers.torch_twins import assert_states_close  # noqa: E402
from tests.test_torch_audio_functional import _speechlike, stand_in_backends  # noqa: E402,F401

SUM_ATOL = 1e-4
STOI_SUM_ATOL = 5e-4


def _clips(seed, shape=(3, 2, 300)):
    rng = np.random.default_rng(seed)
    target = rng.standard_normal(shape).astype(np.float32)
    preds = (target + 0.4 * rng.standard_normal(shape)).astype(np.float32)
    return preds, target


def _run_twins(ours, ref, batches, atol=SUM_ATOL, ops=("update", "forward", "update")):
    for (p, t), op in zip(batches, ops):
        if op == "update":
            ours.update(torch.from_numpy(p), torch.from_numpy(t))
            ref.update(jnp.asarray(p), jnp.asarray(t))
        else:
            np.testing.assert_allclose(ours(torch.from_numpy(p), torch.from_numpy(t)).numpy(), np.asarray(ref(jnp.asarray(p), jnp.asarray(t))), rtol=1e-5, atol=atol)
        assert_states_close(ours.metric_state, dict(ref.metric_state), rtol=0, atol=atol)
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(ref.compute()), rtol=1e-5, atol=atol)


CASES = {
    "snr": ("SignalNoiseRatio", {}), "snr_zero_mean": ("SignalNoiseRatio", {"zero_mean": True}),
    "si_snr": ("ScaleInvariantSignalNoiseRatio", {}),
    "si_sdr": ("ScaleInvariantSignalDistortionRatio", {}), "si_sdr_zero_mean": ("ScaleInvariantSignalDistortionRatio", {"zero_mean": True}),
    "sdr": ("SignalDistortionRatio", {"filter_length": 64}),
    "sdr_cg": ("SignalDistortionRatio", {"filter_length": 64, "use_cg_iter": 10, "load_diag": 1e-4, "zero_mean": True}),
}


@pytest.mark.parametrize("key", sorted(CASES))
def test_audio_metrics_against_jax(key):
    name, kwargs = CASES[key]
    ours, ref = getattr(mtt, name)(device="cpu", **kwargs), getattr(mt, name)(**kwargs)
    _run_twins(ours, ref, [_clips(s) for s in range(3)])
    assert ours.total.dtype == torch.int32 and ours.total.item() == 3 * 3 * 2 - 0


@pytest.mark.parametrize("eval_func", ["max", "min"])
@pytest.mark.parametrize("spk", [2, 3])
def test_pit_against_jax(eval_func, spk):
    ours = mtt.PermutationInvariantTraining(T.scale_invariant_signal_distortion_ratio, eval_func, device="cpu")
    ref = mt.PermutationInvariantTraining(J.scale_invariant_signal_distortion_ratio, eval_func)
    _run_twins(ours, ref, [_clips(10 + s, (4, spk, 200)) for s in range(3)])
    assert ours.total.item() == 12


def test_pit_forwards_its_other_kwargs_to_the_metric():
    """The base ``Metric``'s keyword arguments (``device`` among them) stay
    with the metric; the rest go to ``metric_func``, as in JAX."""
    ours = mtt.PermutationInvariantTraining(T.scale_invariant_signal_distortion_ratio, device="cpu", zero_mean=True)
    ref = mt.PermutationInvariantTraining(J.scale_invariant_signal_distortion_ratio, zero_mean=True)
    assert ours.kwargs == ref.kwargs == {"zero_mean": True} and ours.device == torch.device("cpu")
    _run_twins(ours, ref, [_clips(20 + s, (2, 2, 100)) for s in range(3)])
    with pytest.raises(ValueError, match="eval_func"):
        mtt.PermutationInvariantTraining(T.scale_invariant_signal_distortion_ratio, "median", device="cpu")


def _stand_in_capture(metric):
    """A capture step that runs the body eagerly, so a CPU metric goes
    through ``_capture.py``'s table (eager, capture, replays)."""
    object.__setattr__(metric, "_update_graphs", UpdateGraphs(capture=lambda run, pool: run))
    return metric.__dict__["_update_graphs"]


@pytest.mark.parametrize(
    "make",
    [
        lambda: mtt.ScaleInvariantSignalDistortionRatio(device="cpu"),
        lambda: mtt.SignalNoiseRatio(device="cpu"),
        lambda: mtt.SignalDistortionRatio(filter_length=64, device="cpu"),
        lambda: mtt.SignalDistortionRatio(filter_length=64, use_cg_iter=10, device="cpu"),
        lambda: mtt.PermutationInvariantTraining(T.scale_invariant_signal_distortion_ratio, device="cpu"),
    ],
    ids=["si_sdr", "snr", "sdr", "sdr_cg", "pit"],
)
def test_captured_update_equals_eager(make):
    """The device-only updates capture (nothing is read back) and their
    replays keep the states bit-equal to an eager twin."""
    captured, eager = make(), make()
    table = _stand_in_capture(captured)
    for s in range(4):
        p, t = _clips(30 + s)
        captured.update(torch.from_numpy(p), torch.from_numpy(t))
        eager.update(torch.from_numpy(p), torch.from_numpy(t))
        for k, v in eager.metric_state.items():
            assert torch.equal(captured.metric_state[k], v), k
    assert table.captures == 1 and table.replays == 3 and table.error is None and captured.jittable_update


def _refusing_capture(run, pool):
    """A capture step that refuses a read back to the host, as a CUDA-graph
    capture does: the body runs with ``Tensor.numpy`` raising."""
    real = torch.Tensor.numpy

    def refuse(self, *args, **kwargs):
        raise RuntimeError("operation not permitted when stream is capturing")

    torch.Tensor.numpy = refuse
    try:
        run()
    finally:
        torch.Tensor.numpy = real
    return run


def test_stoi_capture_is_refused_and_runs_eagerly():
    """STOI reads its inputs back by design (VAD and resampling on the
    host): its capture fails, the instance runs eagerly from then on (as
    JAX's failed trace), and the second update runs with no error."""
    ours = mtt.ShortTimeObjectiveIntelligibility(8000, use_device_implementation=True, device="cpu")
    ref = mt.ShortTimeObjectiveIntelligibility(8000, use_device_implementation=True)
    object.__setattr__(ours, "_update_graphs", UpdateGraphs(capture=_refusing_capture))
    table = ours.__dict__["_update_graphs"]
    for seed in range(3):
        clean, noisy = _speechlike(0.8, 8000, seed, 5)
        ours.update(torch.from_numpy(noisy), torch.from_numpy(clean))
        ref.update(jnp.asarray(noisy), jnp.asarray(clean))
        assert_states_close(ours.metric_state, dict(ref.metric_state), rtol=0, atol=STOI_SUM_ATOL)
    assert table.captures == 0 and "capturing" in table.error and not ours.jittable_update
    np.testing.assert_allclose(float(ours.compute()), float(ref.compute()), atol=2e-4)


@pytest.mark.parametrize("extended", [False, True])
def test_native_stoi_module_against_jax(extended):
    ours = mtt.ShortTimeObjectiveIntelligibility(10_000, extended=extended, use_device_implementation=True, device="cpu")
    ref = mt.ShortTimeObjectiveIntelligibility(10_000, extended=extended, use_device_implementation=True)
    pairs = [_speechlike(1.0, 10_000, s, 5) for s in (1, 2)]
    target = np.stack([c for c, _ in pairs])
    preds = np.stack([n for _, n in pairs])
    ours.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert_states_close(ours.metric_state, dict(ref.metric_state), rtol=0, atol=STOI_SUM_ATOL)
    assert ours.total.dtype == torch.int32 and ours.total.item() == 2


def test_gated_classes_refuse_as_jax():
    for name, args in (("PerceptualEvaluationSpeechQuality", (16000, "wb")), ("ShortTimeObjectiveIntelligibility", (16000,))):
        with pytest.raises(ModuleNotFoundError) as ours:
            getattr(mtt, name)(*args, device="cpu")
        with pytest.raises(ModuleNotFoundError) as ref:
            getattr(mt, name)(*args)
        assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize(("name", "args"), [("PerceptualEvaluationSpeechQuality", (16000, "wb")), ("ShortTimeObjectiveIntelligibility", (16000,))])
def test_gated_classes_accumulate_as_jax_through_the_stand_in(stand_in_backends, name, args):
    ours, ref = getattr(mtt, name)(*args, device="cpu"), getattr(mt, name)(*args)
    rng = np.random.default_rng(1)
    for _ in range(3):
        b = rng.normal(size=(2, 320)).astype(np.float32)
        c = rng.normal(size=(2, 320)).astype(np.float32)
        ours.update(torch.from_numpy(b), torch.from_numpy(c))
        ref.update(jnp.asarray(b), jnp.asarray(c))
        assert_states_close(ours.metric_state, dict(ref.metric_state), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(ours.compute()), float(ref.compute()), atol=1e-6)
    if name == "PerceptualEvaluationSpeechQuality":
        with pytest.raises(ValueError, match="fs"):
            mtt.PerceptualEvaluationSpeechQuality(44100, "wb", device="cpu")
        with pytest.raises(ValueError, match="mode"):
            mtt.PerceptualEvaluationSpeechQuality(16000, "ultra", device="cpu")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    n = 4
    store = tmp_path_factory.mktemp("audio4") / "store"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=R.rank_main, args=(r, n, str(store), queue)) for r in range(n)]
    for proc in procs:
        proc.start()
    try:
        results = dict(queue.get(timeout=240) for _ in procs)
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    for r, res in sorted(results.items()):
        if "error" in res:
            pytest.fail(f"rank {r} of {n} failed:\n{res['error']}")
    assert [proc.exitcode for proc in procs] == [0] * n
    return n, [results[r] for r in range(n)]


def test_four_rank_sum_states_match_jax_under_vmap(world4):
    """Four Gloo ranks' synced sum states equal the sum of JAX's shard
    states, and their values JAX's ``functionalize(coll, axis_name="data")``
    under ``jax.vmap``; one ``all_reduce`` per dtype bucket (float32 sums,
    int32 totals) and no gather."""
    n, results = world4
    coll = R.collection(mt, J.scale_invariant_signal_distortion_ratio)
    local = mt.functionalize(coll)
    update = jax.jit(local.update)
    states = []
    for preds, target in R.shards(n):
        s = local.init()
        for i in range(len(preds)):
            s = update(s, jnp.asarray(preds[i : i + 1]), jnp.asarray(target[i : i + 1]))
        states.append(s)
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)
    want = jax.vmap(mt.functionalize(coll, axis_name="data").compute, axis_name="data")(stacked)
    summed = jax.tree_util.tree_map(lambda *x: np.sum([np.asarray(v) for v in x], axis=0).astype(x[0].dtype), *states)
    for res in results:
        assert res["jax_loaded"] == []
        assert sorted(c[:2] for c in res["calls"]) == [("all_reduce", "float32"), ("all_reduce", "int32")]
        assert all(c[2].endswith("SUM") for c in res["calls"])
        for name, value in res["values"].items():
            np.testing.assert_allclose(value, np.asarray(want[name])[0], rtol=1e-5, atol=SUM_ATOL, err_msg=name)
        for name, state in res["synced"].items():
            for key, leaf in state.items():
                ref = np.asarray(summed[name][key])
                assert leaf.dtype == ref.dtype, (name, key)
                np.testing.assert_allclose(leaf, ref, rtol=0, atol=SUM_ATOL, err_msg=f"{name}.{key}")
