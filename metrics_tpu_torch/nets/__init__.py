"""The feature nets of the image metrics (counterpart of ``metrics_tpu/nets/__init__.py``).

torch ``nn.Module`` forms of the reference's InceptionV3 (FID, KID, IS) and
the LPIPS AlexNet/VGG16 stacks, keyed as the torch checkpoints are. Without
weights they are seeded random inits and warn: the architecture is real,
the calibration is not. The names load lazily, so ``import
metrics_tpu_torch`` builds no net. The BERT encoder is not ported yet.
"""
_INCEPTION = ("InceptionV3", "InceptionV3Extractor", "load_inception_torch_state_dict")
_LPIPS = ("AlexNetFeatures", "VGG16Features", "LPIPSNet", "load_lpips_torch_state_dict")

__all__ = [*_INCEPTION, *_LPIPS]


def __getattr__(name: str):
    if name in _INCEPTION:
        import metrics_tpu_torch.nets.inception_v3 as mod
    elif name in _LPIPS:
        import metrics_tpu_torch.nets.lpips_net as mod
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(mod, name)
