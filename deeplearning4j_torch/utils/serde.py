"""JSON serde for config dataclasses.

Reference parity: DL4J serializes every configuration (NeuralNetConfiguration,
MultiLayerConfiguration, ComputationGraphConfiguration, per-layer configs) to
JSON/YAML via a Jackson ObjectMapper with polymorphic subtype registration
(reference: deeplearning4j-nn nn/conf/NeuralNetConfiguration.java:126-127 and
nn/conf/ReflectionsHelper.java classpath scanning for custom layers).

Configs are plain Python dataclasses registered in an explicit registry (no
classpath scanning; `register` is the extension point for custom layers).
`to_dict` emits an `"@class"` tag per registered object so JSON round-trips
reconstruct the exact subtype.

This is the torch package's own copy of `deeplearning4j_tpu/utils/serde.py`
(the port imports nothing of the JAX package). The registered names and the
JSON shape are the same, so a configuration written by either package loads
in the other.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Type] = {}
_ENUM_REGISTRY: Dict[str, Type] = {}


def register(cls=None, *, name: str | None = None):
    """Class decorator: make a dataclass (or Enum) JSON round-trippable.

    This is the custom-layer extension mechanism (the analog of DL4J's
    `NeuralNetConfiguration.registerSubtypes` / Reflections classpath scan).
    """

    def wrap(c):
        key = name or c.__name__
        if isinstance(c, type) and issubclass(c, enum.Enum):
            _ENUM_REGISTRY[key] = c
        else:
            _REGISTRY[key] = c
        c.__serde_name__ = key
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def registered_class(name: str) -> Type:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(
        f"No config class registered under {name!r}. Custom classes must be "
        f"decorated with @serde.register before deserialization."
    )


def to_dict(obj: Any) -> Any:
    """Recursively convert a registered dataclass tree to JSON-able data."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return {"@enum": type(obj).__serde_name__, "value": obj.name}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # vars(), not getattr: a subclass INHERITS its parent's
        # __serde_name__, and serializing it under the parent's tag would
        # silently reconstruct the wrong class (dropping subclass fields)
        name = vars(type(obj)).get("__serde_name__")
        if name is None:
            raise TypeError(
                f"{type(obj).__name__} is a dataclass but not @serde.register'd"
            )
        out = {"@class": name}
        for f in dataclasses.fields(obj):
            if not f.metadata.get("serde_skip", False):
                out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [to_dict(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): to_dict(v) for k, v in obj.items()}
    if callable(obj):
        raise TypeError(
            f"Cannot serialize callable {obj!r}; use a named/registered config "
            f"object instead of a bare function for round-trippable configs."
        )
    raise TypeError(f"Cannot serialize {type(obj)!r}")


def from_dict(data: Any) -> Any:
    if isinstance(data, dict):
        if "@enum" in data:
            return _ENUM_REGISTRY[data["@enum"]][data["value"]]
        if "@class" in data:
            cls = registered_class(data["@class"])
            field_names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {
                k: from_dict(v)
                for k, v in data.items()
                if k != "@class" and k in field_names
            }
            return cls(**kwargs)
        return {k: from_dict(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_dict(x) for x in data]
    return data


def to_json(obj: Any, indent: int | None = 2) -> str:
    return json.dumps(to_dict(obj), indent=indent)


def from_json(s: str) -> Any:
    return from_dict(json.loads(s))
