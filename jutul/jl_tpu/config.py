"""Typed, self-documenting option registry.

JAX-native counterpart of Jutul's ``JutulConfig`` (reference:
src/core_types/core_types.jl JutulConfig, simulator/types.jl:98-119,
src/config.jl:9). Options are declared with ``add_option`` carrying a default,
a short and long description, an expected type, and optionally a set of legal
values; reading/writing unknown keys raises, and value validation runs on every
assignment. Behaves like a mutable mapping.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, Mapping


@dataclass
class _Option:
    default: Any
    short_description: str = ""
    description: str = ""
    types: Any = None  # type or tuple of types, None = anything
    values: Any = None  # iterable of legal values, None = anything
    validator: Callable[[Any], bool] | None = None
    replace: bool = False


class JutulConfig(Mapping):
    """Validated option dictionary (reference src/config.jl:9)."""

    def __init__(self, name: str = "config"):
        self._name = name
        self._options: dict[str, _Option] = {}
        self._values: dict[str, Any] = {}

    # --- declaration -----------------------------------------------------
    def add_option(
        self,
        key: str,
        default: Any,
        short_description: str = "",
        description: str = "",
        types: Any = None,
        values: Any = None,
        validator: Callable[[Any], bool] | None = None,
        replace: bool = False,
    ) -> None:
        if key in self._options and not (replace or self._options[key].replace):
            raise ValueError(
                f"Option {key!r} already defined in {self._name}; "
                "pass replace=True to redefine."
            )
        opt = _Option(default, short_description, description, types, values,
                      validator, replace)
        self._options[key] = opt
        self._values[key] = self._validate(key, default)

    # --- validation ------------------------------------------------------
    def _validate(self, key: str, value: Any) -> Any:
        opt = self._options[key]
        if value is None:
            return value
        if opt.types is not None and not isinstance(value, opt.types):
            # ints are acceptable where floats are expected
            if opt.types is float and isinstance(value, int):
                value = float(value)
            elif isinstance(opt.types, tuple) and float in opt.types and isinstance(value, int):
                value = float(value)
            else:
                raise TypeError(
                    f"{self._name}[{key!r}]: expected {opt.types}, "
                    f"got {type(value).__name__} = {value!r}"
                )
        if opt.values is not None and value not in opt.values:
            raise ValueError(
                f"{self._name}[{key!r}]: {value!r} not in legal values {opt.values}"
            )
        if opt.validator is not None and not opt.validator(value):
            raise ValueError(f"{self._name}[{key!r}]: {value!r} failed validation")
        return value

    # --- mapping protocol ------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        try:
            return self._values[key]
        except KeyError:
            raise KeyError(
                f"Unknown option {key!r} for {self._name}. "
                f"Known: {sorted(self._options)}"
            ) from None

    def __setitem__(self, key: str, value: Any) -> None:
        if key not in self._options:
            raise KeyError(
                f"Unknown option {key!r} for {self._name}. "
                f"Known: {sorted(self._options)}"
            )
        self._values[key] = self._validate(key, value)

    def __iter__(self) -> Iterator[str]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __contains__(self, key: object) -> bool:
        return key in self._values

    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key, default)

    def update(self, other: Mapping | None = None, **kwargs: Any) -> None:
        if other:
            for k, v in other.items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def keys(self):
        return self._values.keys()

    def values(self):
        return self._values.values()

    def items(self):
        return self._values.items()

    def describe(self, key: str | None = None) -> str:
        def one(k: str) -> str:
            o = self._options[k]
            s = f"{k} = {self._values[k]!r} (default {o.default!r})"
            if o.short_description:
                s += f" — {o.short_description}"
            return s

        if key is not None:
            return one(key)
        return "\n".join(one(k) for k in sorted(self._options))

    def __repr__(self) -> str:
        return f"JutulConfig({self._name!r}, {len(self)} options)"
