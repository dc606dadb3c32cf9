"""Factory resolution for the port.

The model factory defaults to the port's own ``model_factory``; a
``model_config.file`` spec (``path/to/file.py:fn`` or ``pkg.mod:fn``) is
resolved by the reference package's JAX-free loader. Datasets come from the
reference package's registry unchanged: they are host-side numpy code.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from slam_llm_tpu.registry import get_custom_dataset_factory, resolve_factory

__all__ = ["get_custom_dataset_factory", "get_custom_model_factory"]


def get_custom_model_factory(model_config) -> Callable[..., Any]:
    spec: Optional[str] = getattr(model_config, "file", None)
    if not spec:
        from slam_llm_tpu_torch.models.slam_model import model_factory

        return model_factory
    return resolve_factory(spec, default_name="model_factory")
