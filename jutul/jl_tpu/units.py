"""SI units utilities.

JAX-native counterpart of Jutul's units module (reference:
src/units/units.jl, src/units/interface.jl). Provides ``si_unit``,
``si_units``, ``convert_to_si`` and ``convert_from_si`` with the same unit
vocabulary. Values are standard physical constants (SI definitions), written
from the published definitions, not from the reference source.

Affine temperature units (Celsius / Fahrenheit) are handled specially in the
conversion functions, matching reference src/units/temperature.jl behavior.
"""

from __future__ import annotations

# Base/derived multiplicative units: 1 <unit> = <value> in SI base units.
_SI_UNITS: dict[str, float] = {}


def _reg(value: float, *names: str) -> None:
    for n in names:
        _SI_UNITS[n] = value


# --- dimensionless / identity
_reg(1.0, "si", "unit")
# --- length
_reg(1.0, "m", "meter")
_reg(0.0254, "in", "inch")
_reg(0.3048, "ft", "feet")
# --- time
_reg(1.0, "s", "second")
_reg(60.0, "minute")
_reg(3600.0, "hour")
_reg(86400.0, "day")
_reg(365.2425 * 86400.0, "year")
# --- mass
_reg(1.0, "kg", "kilogram")
_reg(1e-3, "g", "gram")
_reg(0.45359237, "lb", "pound")
_reg(1000.0, "tonne")
_reg(1.66053906660e-27, "Da", "dalton")
# --- force
_reg(1.0, "N", "newton")
_reg(1e-5, "dyn", "dyne")
_reg(4.4482216152605, "lbf")
# --- pressure
_reg(1.0, "Pa", "pascal")
_reg(101325.0, "atm", "atmosphere")
_reg(1e5, "bar")
_reg(6894.757293168, "psi")
# --- energy / power
_reg(1.0, "J", "joule")
_reg(1055.05585262, "btu", "BTU")
_reg(1.0, "W", "watt")
# --- volume
_reg(1.0, "m3")
_reg(1e-3, "l", "L", "liter", "litre")
_reg(3.785411784e-3, "gal", "Gal", "gallon_us", "usgal")
_reg(0.158987294928, "stb")  # stock tank barrel
# --- permeability
_reg(9.869232667160130e-13, "darcy")
# --- viscosity
_reg(0.1, "poise")
# --- temperature (multiplicative only; affine handled separately)
_reg(1.0, "K", "Kelvin", "kelvin")
_reg(5.0 / 9.0, "R", "Rankine", "rankine")
# --- electromagnetic / chemistry
_reg(1.0, "amp", "ampere")
_reg(1.0, "farad")
_reg(1.0, "mol")
_reg(1.0, "site")

_AFFINE = {
    "Celsius": (1.0, 273.15),
    "celsus": (1.0, 273.15),  # reference ships this misspelled alias
    "degC": (1.0, 273.15),
    "Fahrenheit": (5.0 / 9.0, 255.3722222222222),
    "degF": (5.0 / 9.0, 255.3722222222222),
    "F": (5.0 / 9.0, 255.3722222222222),
}


def si_unit(name) -> float:
    """Value of 1 ``name`` in SI base units (reference src/units/units.jl:1).

    >>> si_unit("day")
    86400.0
    """
    if isinstance(name, (int, float)):
        return float(name)
    name = str(name)
    try:
        return _SI_UNITS[name]
    except KeyError:
        if name in _AFFINE:
            raise ValueError(
                f"Unit {name!r} is affine; use convert_to_si/convert_from_si."
            ) from None
        raise ValueError(f"Unknown unit: {name!r}") from None


def si_units(*names):
    """Tuple of unit values; `a, b = si_units("day", "bar")`."""
    vals = tuple(si_unit(n) for n in names)
    return vals[0] if len(vals) == 1 else vals


def convert_to_si(value, unit):
    """Convert ``value`` given in ``unit`` to SI (handles Celsius/Fahrenheit)."""
    if isinstance(unit, str) and unit in _AFFINE:
        a, b = _AFFINE[unit]
        return value * a + b
    return value * si_unit(unit)


def convert_from_si(value, unit):
    """Convert SI ``value`` to ``unit`` (handles Celsius/Fahrenheit)."""
    if isinstance(unit, str) and unit in _AFFINE:
        a, b = _AFFINE[unit]
        return (value - b) / a
    return value / si_unit(unit)


def all_units() -> dict[str, float]:
    return dict(_SI_UNITS)
