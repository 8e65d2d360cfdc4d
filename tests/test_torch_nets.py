"""The nets of the port (``metrics_tpu_torch/nets/``) and the bundled
encoder (``image/extractor.py``) against JAX's, with weights carried both
ways: a seeded torch state dict loads into the port as it is and into JAX
through JAX's own ``load_inception_torch_state_dict`` /
``load_lpips_torch_state_dict``; JAX's seeded variables load into the port
through ``load_jax_variables`` / ``TinyImageEncoder.load_jax_params``.
``tests/helpers/torch_nets.py``'s twins stand by as a third witness.

Tolerances: taps and distances ``rtol=1e-4``/``atol=1e-5`` (convolutions
sum in another order than XLA's; measured 0 to 1e-6 on this CPU); the
extractor's resize ``atol=1e-5`` on the ``[-1, 1]`` scale (measured
4.2e-6); the loaders' copies exact. The torchvision Inception variant and
LPIPS vgg are marked ``slow``.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from metrics_tpu.image.extractor import TinyImageEncoder as JaxEncoder  # noqa: E402
from metrics_tpu.nets import inception_v3 as jinc  # noqa: E402
from metrics_tpu.nets import lpips_net as jlp  # noqa: E402
from metrics_tpu_torch.image.extractor import TinyImageEncoder  # noqa: E402
from metrics_tpu_torch.nets import inception_v3 as tinc  # noqa: E402
from metrics_tpu_torch.nets import lpips_net as tlp  # noqa: E402
from tests.helpers.torch_nets import TorchInceptionV3, TorchLPIPS, randomize_bn_stats  # noqa: E402

TAPS = (64, 192, 768, 2048)
TOL = {"rtol": 1e-4, "atol": 1e-5}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _jax_state_dict_load(loader, variables, state_dict):
    return _np_tree(loader(variables, {k: v.numpy() for k, v in state_dict.items()}))


def _taps_close(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=str(k), **TOL)


@pytest.fixture(scope="module")
def jax_inception():
    """JAX's InceptionV3 (fid variant) and its own seeded variables, built
    once for the file, with batch-norm statistics made non-trivial."""
    module = jinc.InceptionV3(variant="fid", num_classes=1008)
    variables = _np_tree(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 75, 75))))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(lambda a: a, variables["batch_stats"])

    def perturb(tree):
        return {
            k: perturb(v) if isinstance(v, dict) else
            {"mean": (0.1 * rng.standard_normal(v.shape)).astype(np.float32), "var": rng.uniform(0.5, 1.5, v.shape).astype(np.float32)}[k]
            for k, v in tree.items()
        }

    variables["batch_stats"] = perturb(stats)
    return module, variables


@pytest.fixture(scope="module")
def images75():
    return np.random.default_rng(2).uniform(-1, 1, (2, 3, 75, 75)).astype(np.float32)


def test_inception_jax_variables_load_into_the_port(jax_inception, images75):
    module, variables = jax_inception
    net = tinc.load_jax_variables(tinc.InceptionV3(variant="fid", num_classes=1008), variables)
    with torch.no_grad():
        got = net(torch.from_numpy(images75), features=TAPS)
    want = module.apply(variables, jnp.asarray(images75), features=TAPS)
    assert set(got) == set(want) == {*TAPS, "logits"}
    _taps_close(got, want, want)


@pytest.mark.parametrize("taps", [(64,), (192,), (768,), (64, 768)])
def test_inception_shallow_taps_stop_early(jax_inception, images75, taps):
    module, variables = jax_inception
    net = tinc.load_jax_variables(tinc.InceptionV3(variant="fid", num_classes=1008), variables)
    with torch.no_grad():
        got = net(torch.from_numpy(images75), features=taps)
    want = module.apply(variables, jnp.asarray(images75), features=taps)
    assert set(got) == set(want) == set(taps)
    _taps_close(got, want, taps)


def test_inception_torch_state_dict_loads_into_both(jax_inception, images75):
    """A seeded torch state dict (the twin's torchvision keys, with
    ``AuxLogits`` and ``num_batches_tracked`` as a checkpoint has them)
    loads into the port as it is and into JAX through its own loader."""
    module, variables = jax_inception
    twin = TorchInceptionV3(variant="fid", num_classes=1008)
    randomize_bn_stats(twin, seed=3)
    twin.eval()
    sd = dict(twin.state_dict())
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    net = tinc.load_inception_torch_state_dict(tinc.InceptionV3(variant="fid", num_classes=1008), sd)
    jvars = _jax_state_dict_load(jinc.load_inception_torch_state_dict, variables, sd)
    x = torch.from_numpy(images75)
    with torch.no_grad():
        got = net(x, features=TAPS)
        witness = twin(x, features=TAPS)
    want = module.apply(jvars, jnp.asarray(images75), features=TAPS)
    _taps_close(got, want, want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), witness[k].numpy(), **TOL)


def test_port_state_dict_is_torchvision_keyed():
    net = tinc.InceptionV3(variant="fid", num_classes=1008)
    twin = TorchInceptionV3(variant="fid", num_classes=1008)
    ours, theirs = net.state_dict(), twin.state_dict()
    assert list(ours) == list(theirs)
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    net.load_state_dict(theirs)  # as it is


@pytest.mark.slow
def test_inception_torchvision_variant_against_jax():
    module = jinc.InceptionV3(variant="torchvision", num_classes=1000)
    variables = _np_tree(jax.jit(module.init)(jax.random.PRNGKey(4), jnp.zeros((1, 3, 75, 75))))
    x = np.random.default_rng(5).uniform(-1, 1, (2, 3, 80, 80)).astype(np.float32)
    net = tinc.load_jax_variables(tinc.InceptionV3(variant="torchvision", num_classes=1000), variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x), features=TAPS)
    _taps_close(got, module.apply(variables, jnp.asarray(x), features=TAPS), [*TAPS, "logits"])


def test_inception_loader_refusals(tmp_path):
    net = tinc.InceptionV3(variant="fid", num_classes=1008)
    sd = net.state_dict()
    with pytest.raises(KeyError, match="Mixed_9z"):
        tinc.load_inception_torch_state_dict(net, {"Mixed_9z.conv.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="Shape mismatch at Conv2d_1a_3x3.conv.weight"):
        tinc.load_inception_torch_state_dict(net, {"Conv2d_1a_3x3.conv.weight": torch.zeros(32, 3, 5, 5)})
    # a checkpoint file, wrapped in {"state_dict": ...}, loads by path
    changed = {k: v + 1 if v.is_floating_point() else v for k, v in sd.items()}
    path = tmp_path / "inception.pt"
    torch.save({"state_dict": changed}, path)
    ex = tinc.InceptionV3Extractor(weights=str(path), device="cpu", resize=False)
    assert ex.calibrated
    assert torch.equal(ex.module.Conv2d_1a_3x3.conv.weight, changed["Conv2d_1a_3x3.conv.weight"])
    # a net without a classifier skips fc.*
    headless = tinc.InceptionV3(variant="fid", num_classes=None)
    tinc.load_inception_torch_state_dict(headless, changed)
    with pytest.raises(KeyError, match="Unrecognized InceptionV3"):
        tinc.load_jax_variables(net, {"params": {"Conv2d_1a_3x3": {"conv": {"bias": np.zeros(32)}}}})
    with pytest.raises(ValueError, match="Shape mismatch"):
        tinc.load_jax_variables(net, {"params": {"fc": {"kernel": np.zeros((2048, 10), np.float32)}}})


def test_extractor_resize_against_jax():
    """The bilinear resize to 299: up from 256 and down from 512
    (antialiased, as ``jax.image.resize``), and from a non-square size."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ex = tinc.InceptionV3Extractor(device="cpu")
    rng = np.random.default_rng(6)
    for shape in ((2, 3, 256, 256), (1, 3, 512, 512), (1, 3, 300, 200)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        want = np.asarray(jax.image.resize(jnp.asarray(img, jnp.float32), (shape[0], 3, 299, 299), method="bilinear")) / 127.5 - 1.0
        np.testing.assert_allclose(ex.preprocess(torch.from_numpy(img)).numpy(), want, atol=1e-5)


def test_extractor_taps_and_contract(jax_inception, images75):
    """``taps`` gives the 2048 features and the logits of one forward, the
    call gives its tap, and the weights carry over through the extractor."""
    module, variables = jax_inception
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ex = tinc.InceptionV3Extractor(feature=2048, resize=False, device="cpu")
        logits = tinc.InceptionV3Extractor(feature="logits", resize=False, device="cpu")
    assert (ex.feature_dim, logits.feature_dim) == (2048, 1008)
    tinc.load_jax_variables(ex, variables)
    tinc.load_jax_variables(logits, variables)
    imgs = ((images75 + 1) * 127.5).astype(np.float32)
    both = ex.taps(torch.from_numpy(imgs), (2048,))
    want = module.apply(variables, jnp.asarray(imgs / 127.5 - 1.0), features=(2048,))
    _taps_close(both, want, (2048, "logits"))
    assert torch.equal(ex(torch.from_numpy(imgs)), both[2048])
    assert torch.equal(logits(torch.from_numpy(imgs)), both["logits"])
    assert not any(p.requires_grad for p in ex.module.parameters())
    with pytest.raises(ValueError, match="must be one of"):
        tinc.InceptionV3Extractor(feature=100, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ex(torch.zeros(2, 1, 8, 8))
    with pytest.raises(ValueError, match="Feature tap"):
        ex.module(torch.zeros(1, 3, 75, 75), features=(100,))
    with pytest.raises(ValueError, match="variant"):
        tinc.InceptionV3(variant="v4")


# -- LPIPS ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_lpips_alex():
    module = jlp._LPIPSModule(net_type="alex")
    x = jnp.zeros((1, 3, 64, 64))
    return module, _np_tree(jax.jit(module.init)(jax.random.PRNGKey(0), x, x))


@pytest.fixture(scope="module")
def pairs64():
    rng = np.random.default_rng(7)
    return tuple(rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32) for _ in range(2))


def test_lpips_jax_variables_load_into_the_port(jax_lpips_alex, pairs64):
    module, variables = jax_lpips_alex
    net = tlp.load_jax_variables(tlp._LPIPSModule("alex"), variables)
    a, b = pairs64
    got = net(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(module.apply(variables, jnp.asarray(a), jnp.asarray(b))), **TOL)


def test_lpips_torch_state_dict_loads_into_both(jax_lpips_alex, pairs64):
    """The twin's torchvision backbone and lpips heads (``(1, C, 1, 1)``)
    into the port and into JAX; the twin itself as a third witness."""
    module, variables = jax_lpips_alex
    torch.manual_seed(8)
    twin = TorchLPIPS("alex").eval()
    with torch.no_grad():
        for k in range(5):
            getattr(twin, f"lin{k}")[1].weight.uniform_(0, 1)
    sd = twin.state_dict()
    net = tlp.load_lpips_torch_state_dict(tlp._LPIPSModule("alex"), sd)
    jvars = _jax_state_dict_load(jlp.load_lpips_torch_state_dict, variables, sd)
    a, b = pairs64
    got = net(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(module.apply(jvars, jnp.asarray(a), jnp.asarray(b))), **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(got, twin(torch.from_numpy(a), torch.from_numpy(b)).numpy(), **TOL)


def test_lpips_loader_key_forms():
    """``features.<N>``, ``net.slice<K>.<N>``, ``lin<K>.model.1.weight`` and
    ``lins.<K>.model.1.weight`` load to the same places; classifier and
    scaling keys are skipped; an unknown key and a shape mismatch refuse."""
    base = tlp._LPIPSModule("alex")
    w3 = torch.randn(192, 64, 5, 5)
    lin = torch.rand(1, 384, 1, 1)
    forms = [
        {"features.3.weight": w3, "lin2.model.1.weight": lin, "classifier.1.weight": torch.zeros(3)},
        {"net.slice2.3.weight": w3, "lins.2.model.1.weight": lin, "scaling_layer.shift": torch.zeros(1, 3, 1, 1)},
    ]
    for sd in forms:
        net = tlp.load_lpips_torch_state_dict(tlp._LPIPSModule("alex"), sd)
        assert torch.equal(net.net.features[3].weight, w3)
        assert torch.equal(net.lin2, lin.reshape(-1))
    with pytest.raises(KeyError, match="Unrecognized LPIPS checkpoint key"):
        tlp.load_lpips_torch_state_dict(base, {"head.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="Shape mismatch at net.features.3.weight"):
        tlp.load_lpips_torch_state_dict(base, {"features.3.weight": torch.zeros(192, 64, 3, 3)})
    with pytest.raises(ValueError, match="Shape mismatch at lin0"):
        tlp.load_lpips_torch_state_dict(base, {"lin0.model.1.weight": torch.zeros(1, 65, 1, 1)})
    with pytest.raises(KeyError, match="Unrecognized LPIPS variable"):
        tlp.load_jax_variables(base, {"params": {"head": np.zeros(3)}})


def test_lpips_net_layers_checkpoints_and_warns():
    torch.manual_seed(9)
    twin = TorchLPIPS("alex")
    backbone = {f"features.{k}": v for k, v in twin.features.state_dict().items()}
    heads = {k: v for k, v in twin.state_dict().items() if k.startswith("lin")}
    net = tlp.LPIPSNet("alex", weights=[backbone, heads], device="cpu")
    assert net.calibrated
    assert torch.equal(net.module.net.features[0].weight, twin.features[0].weight)
    assert torch.equal(net.module.lin4, twin.lin4[1].weight.reshape(-1))
    with pytest.warns(UserWarning, match="without pretrained weights"):
        tlp.LPIPSNet("alex", device="cpu")
    with pytest.raises(ValueError, match="net_type"):
        tlp.LPIPSNet("squeeze", device="cpu")
    zero = net(torch.zeros(2, 3, 64, 64), torch.zeros(2, 3, 64, 64))
    assert torch.equal(zero, torch.zeros(2))


@pytest.mark.slow
def test_lpips_vgg_against_jax():
    module = jlp._LPIPSModule(net_type="vgg")
    x = jnp.zeros((1, 3, 64, 64))
    variables = _np_tree(jax.jit(module.init)(jax.random.PRNGKey(1), x, x))
    rng = np.random.default_rng(10)
    a, b = (rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32) for _ in range(2))
    net = tlp.load_jax_variables(tlp._LPIPSModule("vgg"), variables)
    np.testing.assert_allclose(
        net(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy(), np.asarray(module.apply(variables, jnp.asarray(a), jnp.asarray(b))), **TOL
    )
    from tests.helpers.torch_nets import torch_vgg16_features

    assert list(net.net.state_dict()) == [f"features.{k}" for k in torch_vgg16_features().state_dict()]


# -- the bundled encoder -----------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 3, 32, 32), (2, 3, 21, 22), (2, 1, 17, 9)])
def test_tiny_encoder_on_carried_parameters(shape):
    jenc = JaxEncoder(feature_dim=12, in_channels=shape[1], widths=(8, 16), seed=3)
    tenc = TinyImageEncoder(feature_dim=12, in_channels=shape[1], widths=(8, 16), seed=3, device="cpu")
    tenc.load_jax_params([np.asarray(p) for p in jenc.params], np.asarray(jenc.head))
    imgs = np.random.default_rng(11).integers(0, 256, shape).astype(np.uint8)
    for got, want in zip(tenc.feature_maps(torch.from_numpy(imgs)), jenc.feature_maps(jnp.asarray(imgs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tenc(torch.from_numpy(imgs)).numpy(), np.asarray(jenc(jnp.asarray(imgs))), **TOL)


def test_tiny_encoder_seeded_init_and_refusals():
    a = TinyImageEncoder(feature_dim=8, seed=1, device="cpu")
    b = TinyImageEncoder(feature_dim=8, seed=1, device="cpu")
    c = TinyImageEncoder(feature_dim=8, seed=2, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.params, b.params)) and torch.equal(a.head, b.head)
    assert not torch.equal(a.head, c.head)
    with pytest.raises(ValueError, match="Expected images"):
        a(torch.zeros(1, 4, 8, 8))
    with pytest.raises(ValueError, match="Shape mismatch"):
        a.load_jax_params([np.zeros((32, 3, 5, 5))] + [np.asarray(p) for p in a.params[1:]], a.head.numpy())
    with pytest.raises(ValueError, match="conv weights"):
        a.load_jax_params([np.asarray(p) for p in a.params[:1]], a.head.numpy())
