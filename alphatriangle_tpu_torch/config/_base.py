"""Dataclass config base: the pydantic surface the port's callers use.

The JAX package's configs are pydantic models. The port keeps their
field names, defaults and validators but builds them on plain
dataclasses, so it depends on nothing beyond torch and numpy. A JAX
config's `model_dump()` dict loads unchanged through `Cls(**dump)` or
`Cls.model_validate(dump)`.
"""

import dataclasses
from typing import Any, TypeVar

T = TypeVar("T", bound="ConfigBase")


def check_range(
    name: str,
    value,
    *,
    gt: float | None = None,
    ge: float | None = None,
    le: float | None = None,
) -> None:
    """Raise ValueError when `value` breaks a pydantic-style bound."""
    if gt is not None and not value > gt:
        raise ValueError(f"{name}={value!r} must be > {gt}")
    if ge is not None and not value >= ge:
        raise ValueError(f"{name}={value!r} must be >= {ge}")
    if le is not None and not value <= le:
        raise ValueError(f"{name}={value!r} must be <= {le}")


def check_choice(name: str, value, choices: tuple) -> None:
    if value not in choices:
        raise ValueError(f"{name}={value!r} must be one of {choices}")


class ConfigBase:
    """`model_dump` / `model_validate` / `model_copy` over a dataclass."""

    def model_dump(self) -> dict[str, Any]:
        return {
            f.name: _plain(getattr(self, f.name))
            for f in dataclasses.fields(self)  # type: ignore[arg-type]
        }

    @classmethod
    def model_validate(cls: type[T], data: dict[str, Any]) -> T:
        return cls(**data)

    def model_copy(self: T, update: dict[str, Any] | None = None) -> T:
        return dataclasses.replace(self, **(update or {}))  # type: ignore[type-var]


def _plain(value):
    if isinstance(value, list):
        return [_plain(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_plain(v) for v in value)
    return value
