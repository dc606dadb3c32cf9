"""Plugin loading: resolve ``file: path/to/mod.py:factory`` config strings.

Counterpart of ``slam_llm_tpu/registry.py``: the core never imports the
recipes; recipes inject their model factory and dataset factory through
config strings (reference utils/dataset_utils.py:14-46,
utils/model_utils.py:4-29). The model factory defaults to the port's own
``model_factory`` and the dataset factory to the port's speech dataset or,
by ``dataset_config.dataset``, one of its in-tree datasets (``DATASETS``,
every in-tree dataset of the JAX package).

A recipe may name a JAX module in its spec (``vsr_avhubert_vicuna.yaml``'s
``slam_llm_tpu.data.avhubert_dataset:get_avhubert_dataset``). The port never
imports the JAX package: such a spec resolves to the port's module of the
same path under ``slam_llm_tpu_torch``, and raises ``NotImplementedError``
where the port has none. A recipe's model file that imports the JAX
package (``examples/s2s/model/slam_model_s2s.py``) is never executed: its
spec resolves, through the explicit ``PORTED_FILE_SPECS`` table, to the
port's copy of its factory.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path
from typing import Any, Callable, Optional

# dataset_config.dataset -> (module, factory) of the port's in-tree datasets
DATASETS = {
    "speech_dataset": ("slam_llm_tpu_torch.data.speech_dataset", "get_speech_dataset"),
    "audio_dataset": ("slam_llm_tpu_torch.data.audio_dataset", "get_audio_dataset"),
    "mir_dataset": ("slam_llm_tpu_torch.data.mir_dataset", "get_mir_dataset"),
    "echat_dataset": ("slam_llm_tpu_torch.data.echat_dataset", "get_echat_dataset"),
    "spatial_audio_dataset": ("slam_llm_tpu_torch.data.spatial_dataset", "get_spatial_audio_dataset"),
    "avhubert_dataset": ("slam_llm_tpu_torch.data.avhubert_dataset", "get_avhubert_dataset"),
    "speech_dataset_large": ("slam_llm_tpu_torch.data.speech_dataset_large", "get_speech_dataset_large"),
    "s2s_dataset": ("slam_llm_tpu_torch.data.s2s_dataset", "get_s2s_dataset"),
    "vallex_dataset": ("slam_llm_tpu_torch.data.vallex_dataset", "get_vallex_dataset"),
    "text_dataset": ("slam_llm_tpu_torch.data.text_dataset", "get_text_dataset"),
}
# recipe files whose factories import the JAX package: the spec resolves to
# the port's own copy of the factory, and the file is never executed
PORTED_FILE_SPECS = {
    "examples/s2s/model/slam_model_s2s.py:model_factory": ("slam_llm_tpu_torch.models.s2s", "model_factory"),
}
_JAX_PACKAGE = "slam_llm_tpu"


def port_module_name(target: str) -> str:
    """A module path of the JAX package -> the port's module of the same
    path; any other path is returned as it is."""
    if target == _JAX_PACKAGE or target.startswith(_JAX_PACKAGE + "."):
        return "slam_llm_tpu_torch" + target[len(_JAX_PACKAGE):]
    return target


def load_module_from_py_file(py_file: str):
    """Import a python file that is NOT on sys.path as an anonymous module."""
    path = Path(py_file)
    module_name = path.stem + "_" + hex(abs(hash(str(path.resolve()))))[2:10]
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, str(path))
    if spec is None or spec.loader is None:
        raise ImportError(f"Cannot load module from {py_file}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        # don't cache a half-initialized module: a retry would get the
        # broken shell and fail later with a confusing AttributeError
        sys.modules.pop(module_name, None)
        raise
    return module


def _has_module(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:  # a parent package is missing too
        return False


def _ported_file_spec(spec: str, default_name: str):
    """The port's (module, factory) for a ``PORTED_FILE_SPECS`` recipe file,
    named relative to the repository or by any path ending in it; else None."""
    target, func_name = spec.rsplit(":", 1) if ":" in spec else (spec, default_name)
    norm = Path(target).as_posix()
    for known, ported in PORTED_FILE_SPECS.items():
        path, name = known.rsplit(":", 1)
        if name == func_name and (norm == path or norm.endswith("/" + path)):
            return ported
    return None


def resolve_factory(spec: str, default_name: str = "factory") -> Callable[..., Any]:
    """Resolve ``"pkg.mod:fn"``, ``"path/to/file.py:fn"`` or ``"path/to/file.py"``;
    a ``slam_llm_tpu.<m>`` module resolves to ``slam_llm_tpu_torch.<m>``, and
    a ``PORTED_FILE_SPECS`` recipe file to the port's copy of its factory."""
    ported = _ported_file_spec(spec, default_name)
    if ported is not None:
        return getattr(importlib.import_module(ported[0]), ported[1])
    if ":" in spec:
        target, func_name = spec.rsplit(":", 1)
    else:
        target, func_name = spec, default_name
    if target.endswith(".py"):
        module = load_module_from_py_file(target)
    else:
        ported = port_module_name(target)
        if ported != target and not _has_module(ported):
            raise NotImplementedError(f"{target} is not ported: slam_llm_tpu_torch has no module {ported}")
        module = importlib.import_module(ported)
    try:
        return getattr(module, func_name)
    except AttributeError as e:
        raise AttributeError(f"{target} has no factory '{func_name}'") from e


def get_custom_model_factory(model_config) -> Callable[..., Any]:
    spec: Optional[str] = getattr(model_config, "file", None)
    if not spec:
        from slam_llm_tpu_torch.models.slam_model import model_factory

        return model_factory
    return resolve_factory(spec, default_name="model_factory")


def get_custom_dataset_factory(dataset_config) -> Callable[..., Any]:
    """A ``dataset_config.file`` spec, else the in-tree dataset named by
    ``dataset_config.dataset`` (``DATASETS``; an unknown name takes the
    speech dataset, as in the reference)."""
    spec: Optional[str] = getattr(dataset_config, "file", None)
    if spec:
        return resolve_factory(spec, default_name="get_speech_dataset")
    name = getattr(dataset_config, "dataset", "speech_dataset")
    module, factory = DATASETS.get(name, DATASETS["speech_dataset"])
    return getattr(importlib.import_module(module), factory)
