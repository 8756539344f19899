"""Dataclass models with the reference's pydantic conventions, over the
standard library (the card's machine has no pydantic).

Every API type (``api/``, and the message types in ``engine/types.py``)
is a keyword-only dataclass deriving from :class:`APIModel`, which gives it
the slice of pydantic v2's ``BaseModel`` the control plane uses:

- construction and :meth:`APIModel.model_validate` coerce each field to its
  annotation as pydantic's lax mode does (``"3"`` to an ``int``, a dict to
  a nested model, ``1`` to ``True``), check ``Literal`` values and the
  ``gt``/``ge`` bounds of :func:`bounded` fields, run the class's
  ``validate_model`` hook, and raise :class:`ValidationError` (a
  ``ValueError``) naming the field path;
- input keys are accepted both in snake_case and in camelCase
  (``populate_by_name`` with ``alias_generator=to_camel``); unknown keys
  are ignored, as pydantic's default ``extra="ignore"`` does;
- :meth:`APIModel.model_dump` gives plain dicts (snake_case, or camelCase
  with ``by_alias=True``; ``exclude_none`` drops None fields);
- :meth:`APIModel.model_copy` copies, deeply on request.

Assignment is not validated (pydantic's default either); the store
re-validates every document it commits.
"""

from __future__ import annotations

import copy
import dataclasses
import re
import types
import typing
from typing import Any, Literal, Union

__all__ = ["APIModel", "ValidationError", "bounded", "to_camel"]


class ValidationError(ValueError):
    """A value that does not fit its field."""


def to_pascal(snake: str) -> str:
    camel = snake.title()
    return re.sub("([0-9A-Za-z])_(?=[0-9A-Z])", lambda m: m.group(1), camel)


def to_camel(snake: str) -> str:
    """``api_key_from`` -> ``apiKeyFrom``, exactly as
    ``pydantic.alias_generators.to_camel``."""
    if re.match("^[a-z]+[A-Za-z0-9]*$", snake) and not re.search(r"\d[a-z]", snake):
        return snake
    return re.sub("(^_*[A-Z])", lambda m: m.group(1).lower(), to_pascal(snake))


def bounded(default: Any = dataclasses.MISSING, *, default_factory: Any = dataclasses.MISSING,
            gt: float | None = None, ge: float | None = None):
    """A dataclass field with pydantic's ``Field(gt=..., ge=...)`` bounds."""
    meta = {k: v for k, v in (("gt", gt), ("ge", ge)) if v is not None}
    return dataclasses.field(default=default, default_factory=default_factory, metadata=meta)


_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
_HINTS: dict[type, list[tuple[dataclasses.Field, Any]]] = {}


def _fields(cls: type) -> list[tuple[dataclasses.Field, Any]]:
    """(field, resolved annotation) of a dataclass, cached per class."""
    out = _HINTS.get(cls)
    if out is None:
        hints = typing.get_type_hints(cls)
        out = _HINTS[cls] = [(f, hints[f.name]) for f in dataclasses.fields(cls)]
    return out


def _bad(path: str, what: str, value: Any) -> ValidationError:
    return ValidationError(f"{path}: input should be {what}, got {value!r}")


def _scalar(tp: type, value: Any, path: str) -> Any:
    if tp is str:
        if isinstance(value, str):
            return value
        if isinstance(value, bytes):
            return value.decode()
        raise _bad(path, "a valid string", value)
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.strip().lower() in _TRUE | _FALSE:
            return value.strip().lower() in _TRUE
        raise _bad(path, "a valid boolean", value)
    if tp is int:
        if isinstance(value, int):
            return int(value)
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str):
            try:
                return int(value.strip())
            except ValueError:
                try:
                    f = float(value.strip())
                except ValueError:
                    f = None
                if f is not None and f.is_integer():
                    return int(f)
        raise _bad(path, "a valid integer", value)
    if tp is float:
        try:
            if isinstance(value, (int, float)):
                return float(value)
            if isinstance(value, str):
                return float(value.strip())
        except (OverflowError, ValueError):
            pass
        raise _bad(path, "a valid number", value)
    if isinstance(value, tp):
        return value
    raise _bad(path, f"a {tp.__name__}", value)


def coerce(tp: Any, value: Any, path: str = "value") -> Any:
    """``value`` as an instance of the annotation ``tp`` (pydantic's lax
    mode), or :class:`ValidationError`."""
    if tp is Any:
        return value
    origin = typing.get_origin(tp)
    if origin is Union or origin is types.UnionType:
        args = typing.get_args(tp)
        if value is None and type(None) in args:
            return None
        err: ValidationError | None = None
        for arg in args:
            if arg is type(None):
                continue
            try:
                return coerce(arg, value, path)
            except ValidationError as e:
                err = err or e
        raise err or _bad(path, "not None", value)
    if origin is Literal:
        args = typing.get_args(tp)
        if any(value == a and type(value) is type(a) for a in args):
            return value
        raise _bad(path, " or ".join(repr(a) for a in args), value)
    if origin is list or tp is list:
        if not isinstance(value, (list, tuple, set, frozenset)):
            raise _bad(path, "a valid list", value)
        (item,) = typing.get_args(tp) or (Any,)
        return [coerce(item, v, f"{path}.{i}") for i, v in enumerate(value)]
    if origin is dict or tp is dict:
        if not isinstance(value, dict):
            raise _bad(path, "a valid dictionary", value)
        key_tp, val_tp = typing.get_args(tp) or (Any, Any)
        return {coerce(key_tp, k, path): coerce(val_tp, v, f"{path}.{k}")
                for k, v in value.items()}
    if isinstance(tp, type) and issubclass(tp, APIModel):
        if isinstance(value, tp):
            return value
        if isinstance(value, dict):
            return tp.model_validate(value, _path=path)
        raise _bad(path, f"a valid dictionary or {tp.__name__} instance", value)
    if isinstance(tp, type):
        return _scalar(tp, value, path)
    raise TypeError(f"{path}: unsupported annotation {tp!r}")


def _dump(value: Any, by_alias: bool, exclude_none: bool) -> Any:
    if isinstance(value, APIModel):
        return value.model_dump(by_alias=by_alias, exclude_none=exclude_none)
    if isinstance(value, list):
        return [_dump(v, by_alias, exclude_none) for v in value]
    if isinstance(value, dict):
        return {k: _dump(v, by_alias, exclude_none) for k, v in value.items()}
    return copy.deepcopy(value)


class APIModel:
    """Base of every API dataclass (subclasses are declared
    ``@dataclass(kw_only=True)``)."""

    def __post_init__(self) -> None:
        self._coerce_fields(type(self).__name__)

    def _coerce_fields(self, path: str) -> None:
        for f, tp in _fields(type(self)):
            fpath = f"{path}.{f.name}"
            value = coerce(tp, getattr(self, f.name), fpath)
            if value is not None:
                gt, ge = f.metadata.get("gt"), f.metadata.get("ge")
                if gt is not None and not value > gt:
                    raise _bad(fpath, f"greater than {gt}", value)
                if ge is not None and not value >= ge:
                    raise _bad(fpath, f"greater than or equal to {ge}", value)
            object.__setattr__(self, f.name, value)
        try:
            self.validate_model()
        except ValidationError:
            raise
        except ValueError as e:
            raise ValidationError(f"{path}: {e}") from e

    def validate_model(self) -> None:
        """Cross-field checks (pydantic's ``model_validator(mode="after")``);
        raise ``ValueError`` to refuse the object."""

    @classmethod
    def model_validate(cls, data: Any, _path: str | None = None):
        """``data`` (a mapping with snake_case or camelCase keys, or an
        instance) as an instance of ``cls``."""
        path = _path or cls.__name__
        if isinstance(data, cls):
            return data
        if not isinstance(data, dict):
            raise _bad(path, f"a valid dictionary or {cls.__name__} instance", data)
        kw: dict[str, Any] = {}
        missing = []
        for f, _tp in _fields(cls):
            alias = to_camel(f.name)
            if alias in data:
                kw[f.name] = data[alias]
            elif f.name in data:
                kw[f.name] = data[f.name]
            elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
                missing.append(f.name)
        if missing:
            raise ValidationError(f"{path}: missing required field(s) {missing}")
        obj = cls.__new__(cls)
        for f, _tp in _fields(cls):
            if f.name in kw:
                value = kw[f.name]
            elif f.default is not dataclasses.MISSING:
                value = f.default
            else:
                value = f.default_factory()
            object.__setattr__(obj, f.name, value)
        obj._coerce_fields(path)
        return obj

    def model_dump(self, *, by_alias: bool = False, exclude_none: bool = False) -> dict:
        out = {}
        for f, _tp in _fields(type(self)):
            value = getattr(self, f.name)
            if exclude_none and value is None:
                continue
            out[to_camel(f.name) if by_alias else f.name] = _dump(value, by_alias, exclude_none)
        return out

    def model_copy(self, *, deep: bool = False):
        return copy.deepcopy(self) if deep else copy.copy(self)
