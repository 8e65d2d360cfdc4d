"""Float32 FID's floor: the port's ladder and the JAX package's on the same covariances.

``chip_smoke.py``'s ``fid50k_path`` holds float32 FID against scipy's
float64 ``sqrtm`` and the real set against itself. This script shows where
float32 FID's error comes from, on the features that phase makes, in two
steps:

``python3 tools/fid_float32_floor.py card [--out chiprun_out/fid_floor.npz]``
    On a CUDA card, torch only. The ``FID_IMAGES`` real and generated
    images of ``fid50k_path`` (``chip_smoke.image_pair_batch``) go through
    InceptionV3 (fid variant, seed ``chip_smoke.SEED``) twice: with the
    package's seeded init, and with plain He-normal convolutions (the same
    draws, not centred, no ReLU gain), which leave features dead. For each
    init it prints the dead features, the covariance's spectrum, the
    port's float32 FID of the real set against the generated one and
    against itself (with the ladder's rung), scipy's float64 FID from
    float64 statistics of the same features, the port's ladder on the same
    float32 covariances in float64 and in float32 with TF32 on, and one
    float32 product's error against float64; it saves the float32 means
    and covariances that the port's FID read (upper triangles) to ``--out``.

``python3 tools/fid_float32_floor.py cpu [--inp chiprun_out/fid_floor.npz]``
    On the CPU: the JAX package's float32 ``_compute_fid`` and the port's
    ``_compute_fid_with_rung`` on those means and covariances, beside
    scipy's float64 ``sqrtm`` of the same covariances. This step imports
    JAX (as the tests do); the card step does not.
"""
import argparse
import json
import pathlib
import sys
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
INITS = ("seeded", "he_normal")
CASES = {"real_vs_fake": ("real", "fake"), "real_vs_real": ("real", "real")}


def _he_normal(module, seed):
    """Plain He-normal convolutions and dense layers, zero biases: the draws
    of ``nets/_loading.py::seeded_init`` without its centring and gain."""
    import torch
    from torch import nn

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()


def _scipy_fid(mu1, s1, mu2, s2):
    import scipy.linalg

    covmean = scipy.linalg.sqrtm(s1 @ s2)
    return float(((mu1 - mu2) ** 2).sum() + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean).real)


def card(out):
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from metrics_tpu_torch.functional.image import fid as F
    from metrics_tpu_torch.nets import InceptionV3Extractor
    from metrics_tpu_torch.utilities.compute import full_float32

    if not torch.cuda.is_available():
        raise SystemExit("the card step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    saved, report = {}, {"images_per_side": cs.FID_IMAGES}
    iu = np.triu_indices(2048)
    for init in INITS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            extractor = InceptionV3Extractor(2048, variant="fid", seed=cs.SEED, device=dev)
        if init == "he_normal":
            _he_normal(extractor.module, cs.SEED)
        real, fake = [], []
        with torch.no_grad():
            for i in range(cs.FID_IMAGES // cs.FID_BATCH):
                r, g = cs.image_pair_batch(i, cs.FID_BATCH, dev)
                real.append(extractor(r))
                fake.append(extractor(g))
        feats = {"real": torch.cat(real), "fake": torch.cat(fake)}
        stats = {name: F._mean_cov(x) for name, x in feats.items()}
        row = {}
        for name, x in feats.items():
            ev = torch.linalg.eigvalsh(stats[name][1].double())
            row[name] = {"dead_features": int((x.var(dim=0) == 0).sum()), "trace": float(torch.trace(stats[name][1])),
                         "eig_max": float(ev.max()), "eig_min": float(ev.min()),
                         "eigs_below_1e-8_of_max": int((ev < 1e-8 * ev.max()).sum())}
            saved[f"{init}_mu_{name}"] = stats[name][0].cpu().numpy()
            saved[f"{init}_sigma_{name}"] = stats[name][1].cpu().numpy()[iu]
        f64 = {name: (x.double().mean(0), torch.cov(x.double().T)) for name, x in feats.items()}
        for case, (a, b) in CASES.items():
            (mu1, s1, xc), (mu2, s2, yc) = stats[a], stats[b]
            value, rung = F._compute_fid_with_rung(mu1, s1, mu2, s2, centered=(xc, yc))
            t0 = time.perf_counter()
            ref = 0.0 if a == b else _scipy_fid(*(t.cpu().numpy() for t in (*f64[a], *f64[b])))
            scipy_s = time.perf_counter() - t0
            # the same float32 covariances: the ladder in float64 on the
            # card, and in float32 with TF32 on (outside full_float32)
            value64, rung64 = F._compute_fid_with_rung(mu1.double(), s1.double(), mu2.double(), s2.double())
            with cs._tf32_allowed(True):
                tr_tf32, rung_tf32 = F._trace_sqrtm_ladder(s1, s2, centered=(xc, yc))
            value_tf32 = torch.sum((mu1 - mu2) ** 2) + torch.trace(s1) + torch.trace(s2) - 2 * tr_tf32
            # one float32 product against float64: float32's rounding, or TF32's
            with full_float32():
                prod = s1 @ s2
            prod64 = s1.double() @ s2.double()
            traces = row[a]["trace"] + row[b]["trace"]
            row[case] = {"port_float32": float(value), "rung": rung, "scipy_float64": ref, "scipy_s": scipy_s,
                         "err_over_traces": abs(float(value) - ref) / traces,
                         "port_float64_on_float32_covariances": float(value64), "rung_float64": rung64,
                         "port_tf32": float(value_tf32), "rung_tf32": rung_tf32,
                         "product_rel_err_float32": float(torch.linalg.norm(prod.double() - prod64) / torch.linalg.norm(prod64))}
        report[init] = row
        print(json.dumps({init: row}), flush=True)
        del extractor, feats, stats, f64, real, fake
        torch.cuda.empty_cache()
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **saved)
    print(json.dumps(report), flush=True)


def cpu(inp):
    import jax
    import jax.numpy as jnp
    import torch

    sys.path.insert(0, str(ROOT))
    from metrics_tpu.functional.image import fid as jfid
    from metrics_tpu_torch.functional.image import fid as tfid

    jax.config.update("jax_enable_x64", False)
    data = np.load(inp)
    iu = np.triu_indices(2048)

    def sigma(key):
        s = np.zeros((2048, 2048), np.float32)
        s[iu] = data[key]
        return s + np.triu(s, 1).T

    jax_fid = jax.jit(jfid._compute_fid)
    report = {}
    for init in INITS:
        mu = {name: data[f"{init}_mu_{name}"] for name in ("real", "fake")}
        sig = {name: sigma(f"{init}_sigma_{name}") for name in ("real", "fake")}
        row = {}
        for case, (a, b) in CASES.items():
            traces = float(np.trace(sig[a].astype(np.float64)) + np.trace(sig[b].astype(np.float64)))
            jv = float(jax_fid(*(jnp.asarray(v, jnp.float32) for v in (mu[a], sig[a], mu[b], sig[b]))))
            tv, rung = tfid._compute_fid_with_rung(*(torch.from_numpy(v) for v in (mu[a], sig[a], mu[b], sig[b])))
            ref = _scipy_fid(*(v.astype(np.float64) for v in (mu[a], sig[a], mu[b], sig[b])))
            row[case] = {"jax_float32": jv, "port_float32_cpu": float(tv), "port_rung": rung, "scipy_float64_same_covariances": ref,
                         "jax_err_over_traces": abs(jv - ref) / traces, "port_err_over_traces": abs(float(tv) - ref) / traces}
            print(json.dumps({init: {case: row[case]}}), flush=True)
        report[init] = row
    print(json.dumps(report), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("step", choices=("card", "cpu"))
    parser.add_argument("--out", "--inp", dest="path", type=pathlib.Path, default=ROOT / "chiprun_out" / "fid_floor.npz")
    args = parser.parse_args()
    card(args.path) if args.step == "card" else cpu(args.path)


if __name__ == "__main__":
    main()
