"""Reference elements: quadrature rules + basis tabulation (host numpy).

Copies of femo_alpha_tpu/elements/{quadrature,lagrange,tabulation}.py."""

from .quadrature import quadrature_rule
from .tabulation import ElementTables, tabulate, reference_element

__all__ = ["quadrature_rule", "ElementTables", "tabulate", "reference_element"]
