"""The port stands alone: no module of ``metrics_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of ``metrics_tpu``; importing the
package builds and loads no kernel; and a metric with no device asks for
CUDA and never falls back to the CPU."""
import ast
import contextlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import metrics_tpu_torch  # noqa: E402
from metrics_tpu_torch.utilities.exceptions import MetricsTPUUserError  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "metrics_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "metrics_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _is_forbidden(module):
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _is_forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


PACKAGE_FILES = sorted((ROOT / "metrics_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("path", PACKAGE_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_package_imports_no_torchvision_or_scipy(path):
    """The card's machine has no torchvision, and the package needs no
    scipy (``chip_smoke.py`` may use it for a host reference), except
    ``scipy.signal`` inside the function where the JAX package resamples
    STOI's input (``stoi_native.py``'s ``resample_poly``; scipy is on both
    machines), never at import."""
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in ("torchvision", "scipy")]
    if path.relative_to(ROOT).as_posix() == SCIPY_RESAMPLER:
        eager = [m for m in _top_level_imports(path) if m.split(".")[0] == "scipy"]
        assert not eager, f"{SCIPY_RESAMPLER} imports {eager} at import"
        bad = [m for m in bad if m != "scipy.signal"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


SCIPY_RESAMPLER = "metrics_tpu_torch/functional/audio/stoi_native.py"


def _top_level_imports(path):
    """The modules a file imports when it is imported (not inside a
    function or a class)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PACKAGE_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_package_imports_no_transformers_and_no_optional_text_package_eagerly(path):
    """The port never imports ``transformers``; ``nltk``, ``regex`` and
    ``MeCab`` (the text metrics' optional packages, which the card's machine
    lacks) only inside the functions that need them."""
    anywhere = [m for m in _imported_modules(path) if m.split(".")[0] == "transformers"]
    eager = [m for m in _top_level_imports(path) if m.split(".")[0] in ("nltk", "regex", "MeCab", "ipadic")]
    assert not anywhere and not eager, f"{path.relative_to(ROOT)} imports {anywhere + eager}"


def test_text_imports_load_no_jax_no_optional_package_and_construct_no_net():
    """The text metrics, their functions and the nets package import no JAX,
    nothing of ``metrics_tpu``, no ``transformers``, ``nltk``, ``regex`` or
    ``MeCab``, build no kernel, and load no BERT until it is asked for."""
    code = (
        "import sys\n"
        "import metrics_tpu_torch, metrics_tpu_torch.text, metrics_tpu_torch.functional.text, metrics_tpu_torch.nets\n"
        "from metrics_tpu_torch.ops import _build\n"
        "assert _build._loaded == {} and _build.build_info == {}\n"
        "assert 'metrics_tpu_torch.nets.bert_encoder' not in sys.modules\n"
        "bad = ('jax', 'metrics_tpu', 'transformers', 'nltk', 'regex', 'MeCab', 'triton')\n"
        "assert not any(m.split('.')[0] in bad for m in sys.modules), sorted(m for m in sys.modules if m.split('.')[0] in bad)\n"
        "metrics_tpu_torch.nets.BertEncoder\n"
        "assert 'metrics_tpu_torch.nets.bert_encoder' in sys.modules\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_bert_encoder_without_device_asks_for_cuda(monkeypatch):
    """The BERT trunk's parameters and outputs live on the encoder's device:
    CUDA unless the caller asks for the CPU."""
    from metrics_tpu_torch.nets import BertConfigLite, BertEncoder

    def tokenizer(texts, max_length):
        ids = torch.tensor([[101, 7, 8, 102]] * len(texts))
        return ids, torch.ones_like(ids)

    cfg = BertConfigLite(vocab_size=128, hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
        BertEncoder(tokenizer, cfg=cfg)
    with pytest.warns(UserWarning, match="without pretrained weights"):
        enc = BertEncoder(tokenizer, cfg=cfg, device="cpu")
    assert all(p.device.type == "cpu" for p in enc.module.parameters())
    assert all(t.device.type == "cpu" for t in enc(["a b"]))


def test_scan_sees_forbidden_imports():
    assert _is_forbidden("metrics_tpu.ops") and _is_forbidden("jax.numpy") and _is_forbidden("metrics_tpu")
    assert not _is_forbidden("metrics_tpu_torch.ops") and not _is_forbidden("torch")


def test_import_loads_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import metrics_tpu_torch, metrics_tpu_torch.interop\n"
        "from metrics_tpu_torch.ops import _build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu'))\n"
        "assert not bad, bad\n"
        "assert _build._loaded == {} and _build.build_info == {}\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_streaming_import_builds_and_loads_no_kernel():
    code = (
        "import sys\n"
        "import metrics_tpu_torch.streaming\n"
        "from metrics_tpu_torch.ops import _build, compactor\n"
        "assert _build._loaded == {} and _build.build_info == {}\n"
        "assert compactor.launch_count == 0\n"
        "assert 'triton' not in sys.modules and not any(m.split('.')[0] in ('jax', 'metrics_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_curve_and_sync_imports_build_and_load_no_kernel():
    code = (
        "import sys\n"
        "import metrics_tpu_torch.parallel, metrics_tpu_torch.ops.histogram, metrics_tpu_torch.ops.bucketed_rank\n"
        "import metrics_tpu_torch.classification.auroc, metrics_tpu_torch.utilities.ringbuffer\n"
        "from metrics_tpu_torch.ops import _build, histogram\n"
        "assert _build._loaded == {} and _build.build_info == {}\n"
        "assert histogram.launch_count == 0\n"
        "assert 'triton' not in sys.modules and not any(m.split('.')[0] in ('jax', 'metrics_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_fused_sync_and_fault_channel_imports_build_and_load_no_kernel():
    code = (
        "import sys\n"
        "import metrics_tpu_torch.parallel.sync, metrics_tpu_torch.utilities.guard, metrics_tpu_torch.aggregation\n"
        "import metrics_tpu_torch.classification.precision_recall, metrics_tpu_torch.classification.f_beta\n"
        "import metrics_tpu_torch.functional.classification.precision_recall, metrics_tpu_torch.functional.classification.f_beta\n"
        "from metrics_tpu_torch.ops import _build\n"
        "assert _build._loaded == {} and _build.build_info == {}\n"
        "assert 'triton' not in sys.modules and not any(m.split('.')[0] in ('jax', 'metrics_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sync_layer_imports_load_no_jax_build_nothing_and_start_no_thread():
    """The sync layer's modules import no JAX and nothing of
    ``metrics_tpu`` (not even its standard-library ``parallel/retry.py``,
    ``ops/_envtools.py`` or ``resilience/health.py``), build no kernel, and
    start no scheduler or transport thread until a metric asks."""
    code = (
        "import sys, threading\n"
        "import metrics_tpu_torch.ops._envtools, metrics_tpu_torch.ops.quantize, metrics_tpu_torch.parallel.retry\n"
        "import metrics_tpu_torch.parallel.async_sync, metrics_tpu_torch.resilience.health, metrics_tpu_torch.streaming.windowed\n"
        "import metrics_tpu_torch.metric, metrics_tpu_torch.collections, metrics_tpu_torch.interop\n"
        "from metrics_tpu_torch.ops import _build\n"
        "assert _build._loaded == {} and _build.build_info == {}\n"
        "assert [t.name for t in threading.enumerate()] == ['MainThread']\n"
        "assert 'triton' not in sys.modules and not any(m.split('.')[0] in ('jax', 'metrics_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_image_imports_load_no_jax_build_nothing_and_construct_no_net():
    """The image metrics, their functions and the nets package import no
    JAX, nothing of ``metrics_tpu``, no torchvision and no scipy, build no
    kernel, and construct no net (the nets load lazily)."""
    code = (
        "import sys\n"
        "import metrics_tpu_torch, metrics_tpu_torch.image, metrics_tpu_torch.functional.image, metrics_tpu_torch.nets\n"
        "from metrics_tpu_torch.ops import _build\n"
        "assert _build._loaded == {} and _build.build_info == {}\n"
        "assert 'metrics_tpu_torch.nets.inception_v3' not in sys.modules and 'metrics_tpu_torch.nets.lpips_net' not in sys.modules\n"
        "assert not any(m.split('.')[0] in ('jax', 'metrics_tpu', 'torchvision', 'scipy', 'triton') for m in sys.modules)\n"
        "metrics_tpu_torch.nets.InceptionV3Extractor, metrics_tpu_torch.image.LPIPSNet\n"
        "assert 'metrics_tpu_torch.nets.inception_v3' in sys.modules and 'metrics_tpu_torch.nets.lpips_net' in sys.modules\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["InceptionV3Extractor", "LPIPSNet", "TinyImageEncoder"])
def test_nets_without_device_ask_for_cuda(name, monkeypatch):
    """A net's parameters live on its device: CUDA unless the caller asks
    for the CPU."""
    import metrics_tpu_torch.image as timage

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
        getattr(timage, name)()
    with pytest.warns() if name != "TinyImageEncoder" else contextlib.nullcontext():
        net = getattr(timage, name)(device="cpu")
    module = getattr(net, "module", None)
    tensors = list(module.parameters()) if module is not None else [*net.params, net.head]
    assert all(t.device.type == "cpu" for t in tensors)


@pytest.mark.parametrize(
    "name",
    [
        "torch_thread_world.py", "torch_twin_world.py", "torch_pure_ranks.py", "torch_twins.py",
        "torch_retrieval_ranks.py", "torch_sliced_ranks.py", "torch_text_ranks.py", "torch_audio_ranks.py",
        "torch_lockwitness_ranks.py",
    ],
)
def test_rank_helpers_import_no_jax(name):
    path = ROOT / "tests" / "helpers" / name
    bad = [m for m in _imported_modules(path) if _is_forbidden(m)]
    assert not bad, bad


def test_fused_sync_rank_helper_imports_no_jax():
    """The ranks of ``tests/test_torch_fused_sync.py`` run this module."""
    path = ROOT / "tests" / "helpers" / "torch_fused_sync_ranks.py"
    bad = [m for m in _imported_modules(path) if _is_forbidden(m)]
    assert not bad, bad


def test_classification_and_runtime_imports_load_no_jax_and_build_nothing():
    """The confusion-matrix family, calibration, hinge, KL, ranking and the
    runtime's arithmetic and snapshots import no JAX and nothing of
    ``metrics_tpu``, and build no kernel until a CUDA tensor asks."""
    code = (
        "import sys\n"
        "import metrics_tpu_torch.classification.confusion_matrix, metrics_tpu_torch.classification.cohen_kappa\n"
        "import metrics_tpu_torch.classification.matthews_corrcoef, metrics_tpu_torch.classification.jaccard\n"
        "import metrics_tpu_torch.classification.specificity, metrics_tpu_torch.classification.dice\n"
        "import metrics_tpu_torch.classification.hamming, metrics_tpu_torch.classification.calibration_error\n"
        "import metrics_tpu_torch.classification.hinge, metrics_tpu_torch.classification.kl_divergence\n"
        "import metrics_tpu_torch.classification.ranking, metrics_tpu_torch.functional.classification\n"
        "from metrics_tpu_torch.metric import CompositionalMetric\n"
        "from metrics_tpu_torch.ops import _build, histogram\n"
        "assert _build._loaded == {} and _build.build_info == {} and histogram.launch_count == 0\n"
        "assert 'triton' not in sys.modules and not any(m.split('.')[0] in ('jax', 'metrics_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_pure_regression_and_wrapper_imports_load_no_jax_and_build_nothing():
    """The pure layer, the wrappers, regression and pairwise import no JAX
    and nothing of ``metrics_tpu``, and build no kernel until a CUDA tensor
    asks."""
    code = (
        "import sys\n"
        "import metrics_tpu_torch.pure, metrics_tpu_torch.wrappers, metrics_tpu_torch.regression\n"
        "import metrics_tpu_torch.functional.regression, metrics_tpu_torch.functional.pairwise\n"
        "from metrics_tpu_torch.interop import load_jax_pure_state, to_jax_pure_state\n"
        "from metrics_tpu_torch.ops import _build, binned_counters, histogram\n"
        "assert _build._loaded == {} and _build.build_info == {}\n"
        "assert binned_counters.launch_count == histogram.launch_count == 0\n"
        "assert 'triton' not in sys.modules and not any(m.split('.')[0] in ('jax', 'metrics_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_retrieval_sliced_and_padding_imports_load_no_jax_and_build_nothing():
    """Retrieval, the sliced metrics, the padding ladder and the sliced pure
    layer import no JAX and nothing of ``metrics_tpu``, and build no kernel
    until a CUDA tensor asks."""
    code = (
        "import sys\n"
        "import metrics_tpu_torch.retrieval, metrics_tpu_torch.functional.retrieval, metrics_tpu_torch.functional\n"
        "import metrics_tpu_torch.sliced, metrics_tpu_torch.ops.padding\n"
        "from metrics_tpu_torch.pure import sliced_functionalize\n"
        "from metrics_tpu_torch.ops import _build, binned_counters, histogram\n"
        "assert _build._loaded == {} and _build.build_info == {}\n"
        "assert binned_counters.launch_count == histogram.launch_count == 0\n"
        "assert 'triton' not in sys.modules and not any(m.split('.')[0] in ('jax', 'metrics_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_serving_and_capture_imports_load_no_jax_build_nothing_and_start_no_thread():
    """The compiled update and serving import no JAX and nothing of
    ``metrics_tpu``, build no kernel and start no thread."""
    code = (
        "import sys, threading\n"
        "import metrics_tpu_torch, metrics_tpu_torch.serving, metrics_tpu_torch._capture\n"
        "from metrics_tpu_torch.ops import _build\n"
        "assert _build._loaded == {} and _build.build_info == {}\n"
        "assert threading.active_count() == 1\n"
        "assert 'triton' not in sys.modules and not any(m.split('.')[0] in ('jax', 'metrics_tpu') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sliced_metric_and_retrieval_rings_ask_for_cuda(monkeypatch):
    """A ``SlicedMetric`` takes its device from the metric it wraps; a
    retrieval metric in the capacity mode keeps its rings on its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
        metrics_tpu_torch.SlicedMetric(metrics_tpu_torch.SumMetric(device="cpu"), num_slices=3, device="cuda")
    with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
        metrics_tpu_torch.SlicedMetric(metrics_tpu_torch.SumMetric(), num_slices=3)
    metric = metrics_tpu_torch.SlicedMetric(metrics_tpu_torch.SumMetric(device="cpu"), num_slices=3)
    assert metric.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for v in metric.metric_state.values() for t in getattr(v, "counts", v).reshape(1, -1))
    with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
        metrics_tpu_torch.RetrievalMAP(capacity=8, num_queries=2)
    ring = metrics_tpu_torch.RetrievalMAP(capacity=8, num_queries=2, device="cpu")
    assert all(t.device.type == "cpu" for v in ring.metric_state.values() for t in v)


def test_classification_rank_helper_imports_no_jax():
    """The ranks of ``tests/test_torch_compositional.py`` run this module."""
    path = ROOT / "tests" / "helpers" / "torch_classification_ranks.py"
    bad = [m for m in _imported_modules(path) if _is_forbidden(m)]
    assert not bad, bad


# the constructor arguments a class needs besides its device
_NEEDS = {
    "ConfusionMatrix": {"num_classes": 3},
    "CohenKappa": {"num_classes": 3},
    "MatthewsCorrCoef": {"num_classes": 3},
    "JaccardIndex": {"num_classes": 3},
    "Specificity": {"num_classes": 3, "average": "macro"},
    "Dice": {"num_classes": 3, "average": "macro"},
}


@pytest.mark.parametrize(
    "name",
    [
        "Accuracy", "StatScores", "BinnedAveragePrecision", "AUROC", "AveragePrecision", "ROC", "PrecisionRecallCurve", "AUC",
        "Precision", "Recall", "F1Score", "FBetaScore", "MaxMetric", "MinMetric", "SumMetric", "MeanMetric", "CatMetric",
        "WindowedMetric", "DecayedMetric",
        "ConfusionMatrix", "CohenKappa", "MatthewsCorrCoef", "JaccardIndex", "Specificity", "Dice", "HammingDistance",
        "CalibrationError", "HingeLoss", "KLDivergence", "CoverageError", "LabelRankingAveragePrecision", "LabelRankingLoss",
        "MeanSquaredError", "MeanAbsoluteError", "MeanSquaredLogError", "MeanAbsolutePercentageError",
        "SymmetricMeanAbsolutePercentageError", "WeightedMeanAbsolutePercentageError", "CosineSimilarity",
        "ExplainedVariance", "PearsonCorrCoef", "R2Score", "SpearmanCorrCoef", "TweedieDevianceScore",
        "ClasswiseWrapper", "MinMaxMetric", "MultioutputWrapper", "BootStrapper",
        "RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut",
        "RetrievalNormalizedDCG", "RetrievalHitRate", "RetrievalRPrecision", "RetrievalPrecisionRecallCurve",
        "RetrievalRecallAtFixedPrecision",
        "PeakSignalNoiseRatio", "StructuralSimilarityIndexMeasure", "MultiScaleStructuralSimilarityIndexMeasure",
        "UniversalImageQualityIndex", "ErrorRelativeGlobalDimensionlessSynthesis", "SpectralAngleMapper",
        "SpectralDistortionIndex", "FrechetInceptionDistance", "KernelInceptionDistance", "InceptionScore",
        "LearnedPerceptualImagePatchSimilarity",
        "WordErrorRate", "CharErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved",
        "ExtendedEditDistance", "TranslationEditRate", "BLEUScore", "SacreBLEUScore", "CHRFScore", "SQuAD",
        "ROUGEScore", "BERTScore",
    ],
)
def test_metric_without_device_asks_for_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs = {"num_classes": 3} if name.startswith("Binned") else dict(_NEEDS.get(name, {}))
    if name in ("Precision", "Recall", "F1Score", "FBetaScore"):
        kwargs = {"num_classes": 3, "average": "macro", "on_invalid": "drop"}
    if name in ("ClasswiseWrapper", "MinMaxMetric", "MultioutputWrapper", "BootStrapper"):
        # a wrapper takes its device from the metric it wraps
        extra = {"num_outputs": 2} if name == "MultioutputWrapper" else {}
        metric = getattr(metrics_tpu_torch, name)(metrics_tpu_torch.MeanSquaredError(device="cpu"), **extra)
        assert metric.device == torch.device("cpu")
        with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
            getattr(metrics_tpu_torch, name)(metrics_tpu_torch.MeanSquaredError(), **extra)
        return
    if name in ("WindowedMetric", "DecayedMetric"):
        # a wrapper takes its device from the metric it wraps
        extra = {"window": 8, "buckets": 2} if name == "WindowedMetric" else {"halflife": 4.0}
        with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
            getattr(metrics_tpu_torch, name)(metrics_tpu_torch.SumMetric(device="cpu"), device="cuda", **extra)
        metric = getattr(metrics_tpu_torch, name)(metrics_tpu_torch.SumMetric(device="cpu"), **extra)
        assert metric.device == torch.device("cpu")
        return
    with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
        getattr(metrics_tpu_torch, name)(**kwargs)
    with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
        getattr(metrics_tpu_torch, name)(device="cuda", **kwargs)
    metric = getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
    assert metric.device == torch.device("cpu")
    tensors = [t for v in metric.metric_state.values() for t in (v if isinstance(v, (list, tuple)) else [v])]
    assert all(t.device.type == "cpu" for t in tensors)
    if name in ("AUROC", "AveragePrecision", "ROC", "PrecisionRecallCurve", "AUC", "FrechetInceptionDistance", "InceptionScore"):
        extra = {"feature": 8} if name in ("FrechetInceptionDistance", "InceptionScore") else {}
        ring = getattr(metrics_tpu_torch, name)(device="cpu", capacity=8, **extra)
        assert all(t.device.type == "cpu" for v in ring.metric_state.values() for t in v)
    if name == "LearnedPerceptualImagePatchSimilarity":
        assert all(p.device.type == "cpu" for p in metric.net.module.parameters())


def test_a_composition_takes_its_operands_device(monkeypatch):
    """A ``CompositionalMetric`` asks for no device of its own: it runs where
    its metric operands run, and one of CPU metrics never asks for CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = metrics_tpu_torch.Precision(num_classes=3, average="macro", device="cpu")
    r = metrics_tpu_torch.Recall(num_classes=3, average="macro", device="cpu")
    assert (2 * p * r / (p + r)).device == torch.device("cpu")


def test_obs_resilience_and_backend_import_no_jax_and_touch_no_cuda():
    """The observability, snapshot and bootstrap modules import no JAX and
    nothing of ``metrics_tpu``, and importing them (and the package) starts
    no CUDA initialisation."""
    code = (
        "import sys, torch\n"
        "import metrics_tpu_torch.obs, metrics_tpu_torch.obs.drift, metrics_tpu_torch.obs.flightrec\n"
        "import metrics_tpu_torch.resilience.snapshot, metrics_tpu_torch.utilities.backend\n"
        "import metrics_tpu_torch as mtt\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'metrics_tpu')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert mtt.health_report()['backend']['initialized'] is False\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("METRICS_TPU_FORCE_CPU", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_audio_and_witness_imports_load_no_jax_no_scipy_and_build_nothing():
    """The audio metrics, their functions and the lock witness import no
    JAX, nothing of ``metrics_tpu``, no scipy (STOI's resampler imports it
    when it resamples), build no kernel and start no thread; unarmed, the
    named locks are the plain locks."""
    code = (
        "import sys, threading\n"
        "import metrics_tpu_torch.audio, metrics_tpu_torch.functional.audio, metrics_tpu_torch.analysis\n"
        "from metrics_tpu_torch.analysis import lockwitness\n"
        "from metrics_tpu_torch.ops import _build\n"
        "from metrics_tpu_torch.parallel import sync\n"
        "assert _build._loaded == {} and _build.build_info == {}\n"
        "assert threading.active_count() == 1\n"
        "assert type(sync.gather_sequence_lock) is type(threading.RLock()) and type(_build._lock) is type(threading.Lock())\n"
        "assert not any(m.split('.')[0] in ('jax', 'metrics_tpu', 'scipy', 'triton') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "METRICS_TPU_LOCKCHECK"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _sdr(preds, target):
    from metrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio

    return scale_invariant_signal_distortion_ratio(preds, target)


@pytest.mark.parametrize(
    ("name", "kwargs"),
    [
        ("SignalDistortionRatio", {}), ("ScaleInvariantSignalDistortionRatio", {}), ("SignalNoiseRatio", {}),
        ("ScaleInvariantSignalNoiseRatio", {}), ("PermutationInvariantTraining", {"metric_func": _sdr}),
        ("ShortTimeObjectiveIntelligibility", {"fs": 8000, "use_device_implementation": True}),
    ],
)
def test_audio_metric_without_device_asks_for_cuda(name, kwargs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
        getattr(metrics_tpu_torch, name)(**kwargs)
    metric = getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
    assert metric.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in metric.metric_state.values())


def test_native_stoi_and_gated_wrappers_ask_for_cuda(monkeypatch):
    """``stoi_on_device`` runs its core on CUDA unless the caller asks for
    the CPU, with numpy input too."""
    from metrics_tpu_torch.functional.audio import stoi_on_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    with pytest.raises(MetricsTPUUserError, match="no CUDA device"):
        stoi_on_device(x, x, fs=10_000)
    assert stoi_on_device(x, x, fs=10_000, device="cpu").device.type == "cpu"
