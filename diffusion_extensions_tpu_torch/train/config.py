"""Config plumbing (counterpart of
``diffusion_extensions_tpu/train/config.py``): one flat dict (an argparse
namespace's ``vars``) feeds many constructors by their signatures, the
reference's ``init_from_dict`` pattern."""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Mapping

__all__ = ["init_from_dict", "dataclass_from_dict"]


def init_from_dict(argdict: Mapping[str, Any], *classes):
    """Instantiate each class from the keys of ``argdict`` that its
    signature names; missing and extra keys are ignored."""
    objs = []
    for cls in classes:
        names = [k for k, v in inspect.signature(cls).parameters.items()
                 if v.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                               inspect.Parameter.KEYWORD_ONLY)]
        objs.append(cls(**{k: v for k, v in argdict.items() if k in names}))
    return objs


def dataclass_from_dict(cls, argdict: Mapping[str, Any]):
    """Fill a dataclass from a flat dict, ignoring unknown keys."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in argdict.items() if k in names})
