"""Configuration bridge from the JAX package, for the parity tests.

`config_from_jax` turns a `hairsplitter_tpu` PipelineConfig into the port's,
field for field, so both packages run the identical configuration. It reads
the JAX objects by attribute only and imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import fields

from .core.mapping import MapConfig
from .ops.align import BandSpec
from .pipeline.call_variants import VariantCallConfig
from .pipeline.orchestrate import PipelineConfig
from .pipeline.separate_reads import SeparateConfig


def _copy(cls, src, **overrides):
    kw = {f.name: getattr(src, f.name) for f in fields(cls) if hasattr(src, f.name)}
    kw.update(overrides)
    return cls(**kw)


def config_from_jax(cfg, device: str = "cpu") -> PipelineConfig:
    """The port's PipelineConfig equal to the JAX package's `cfg`."""
    spec = BandSpec(chunk=cfg.map.spec.chunk, band=cfg.map.spec.band)
    return _copy(
        PipelineConfig,
        cfg,
        map=_copy(MapConfig, cfg.map, spec=spec),
        variants=_copy(VariantCallConfig, cfg.variants),
        separate=_copy(SeparateConfig, cfg.separate),
        device=device,
    )
