"""Parameter handling - the Teuchos::ParameterList role; a copy of the JAX
package's ``config.py`` (the port imports nothing of that package).

The reference reads an XML parameter file with nested sublists
("Lyapunov Solver", "Eigenvalue Solver") and looks parameters up
spelling-insensitively (exact / UPPER / lower / Title Case,
get_parameter at src/LyapunovSolver.hpp:40-70).  This module provides:

- ``ParameterList``: a dict with the same case-insensitive ``get`` and
  nested ``sublist`` access;
- loaders for the Teuchos XML format and for JSON;
- ``solver_options_from_params``: maps the reference's C++ parameter
  names onto SolverOptions.
"""

from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from typing import Any, Dict

from rails_tpu_torch.core.options import SolverOptions

__all__ = ["ParameterList", "load_xml_parameters", "load_json_parameters",
           "solver_options_from_params"]


def _spelling_variants(name: str):
    yield name
    yield name.upper()
    yield name.lower()
    # Title Case: capitalize the first letter of each word
    yield " ".join(w[:1].upper() + w[1:] if w else w for w in name.split(" "))


class ParameterList(dict):
    """Case/spelling-insensitive parameter dictionary."""

    def get(self, name: str, default: Any = None) -> Any:
        # exact match first, then UPPER/lower/Title, then any case: the
        # first hit wins, so a later variant key never overrides an exact
        # match
        for variant in _spelling_variants(name):
            if variant in self:
                return self[variant]
        for k, v in self.items():
            if isinstance(k, str) and k.lower() == name.lower():
                return v
        return default

    def sublist(self, name: str) -> "ParameterList":
        sub = self.get(name)
        if sub is None:
            sub = ParameterList()
            self[name] = sub
        elif not isinstance(sub, ParameterList):
            sub = ParameterList(sub)
            self[name] = sub
        return sub


def _parse_teuchos_value(type_str: str, value: str):
    t = (type_str or "string").lower()
    if t == "int":
        return int(value)
    if t == "double":
        return float(value)
    if t == "bool":
        return value.strip().lower() in ("true", "1", "yes")
    return value


def _parse_teuchos_list(elem) -> ParameterList:
    out = ParameterList()
    for child in elem:
        if child.tag == "ParameterList":
            out[child.get("name", "")] = _parse_teuchos_list(child)
        elif child.tag == "Parameter":
            out[child.get("name", "")] = _parse_teuchos_value(
                child.get("type"), child.get("value", ""))
    return out


def load_xml_parameters(path: str) -> ParameterList:
    """Teuchos ParameterList XML (the reference's config format,
    src/main.cpp:55-60)."""
    root = ET.parse(path).getroot()
    if root.tag != "ParameterList":
        raise ValueError(f"not a Teuchos ParameterList file: {path}")
    return _parse_teuchos_list(root)


def load_json_parameters(path: str) -> ParameterList:
    with open(path) as f:
        return json.load(f, object_hook=ParameterList)


# C++ parameter name -> SolverOptions field
# (set_parameters, src/LyapunovSolver.hpp:74-98)
_CPP_PARAM_MAP = {
    "Maximum iterations": "maxit",
    "Tolerance": "tol",
    "Expand size": "expand",
    "Lanczos iterations": "lanczos_vectors",
    "Restart size": "restart_size",
    "Reduced size": "reduced_size",
    "Restart iterations": "restart_iterations",
    "Restart tolerance": "restart_tolerance",
    "Minimize solution space": "restart_upon_convergence",
    "Restart from solution": "restart_from_solution",
}


def solver_options_from_params(params: ParameterList,
                               **overrides) -> SolverOptions:
    kw: Dict[str, Any] = {}
    for cpp_name, field in _CPP_PARAM_MAP.items():
        val = params.get(cpp_name)
        if val is not None:
            kw[field] = val
    # also accept SolverOptions field names directly
    for key, val in params.items():
        if isinstance(val, ParameterList):
            continue
        if key in SolverOptions.__dataclass_fields__:
            kw[key] = val
    kw.update(overrides)
    if "maxit" in kw:
        kw["maxit"] = int(kw["maxit"])
    for int_field in ("expand", "restart_size", "reduced_size",
                      "restart_iterations", "lanczos_vectors"):
        if int_field in kw and kw[int_field] is not None:
            kw[int_field] = int(kw[int_field])
    return SolverOptions(**kw)
