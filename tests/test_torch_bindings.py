"""The ctypes bindings of the port's kernels against their CUDA sources.

Each kernel module declares its C entry points and their ``argtypes`` in
``_SIGNATURES``; ``_build.load`` binds them to ``csrc/<module>.cu``'s
library. A renamed or mis-declared entry point would show only when the
library is loaded on the card, so this reads each source as text: every
declared symbol has an ``extern "C" int <symbol>(`` definition whose
parameter count is the number of declared ``argtypes``. No ``nvcc``
needed.
"""
from __future__ import annotations

import importlib
import re

import pytest

from repro_torch.kernels import _build

MODULES = ("kge_score", "topk", "sharded_gather", "rgcn_message",
           "wkv_chunk")


def signatures():
    for module in MODULES:
        sigs = importlib.import_module(f"repro_torch.kernels.{module}")
        for symbol, argtypes in sigs._SIGNATURES.items():
            yield pytest.param(module, symbol, len(argtypes),
                               id=f"{module}.{symbol}")


def c_parameters(source: str, symbol: str):
    """The parameter list of ``extern "C" int symbol(...)`` in ``source``,
    one string per parameter; ``None`` if there is no such definition."""
    m = re.search(r'extern\s+"C"\s+int\s+' + re.escape(symbol) + r"\s*\(",
                  source)
    if m is None:
        return None
    depth, i = 1, m.end()
    while depth:
        depth += {"(": 1, ")": -1}.get(source[i], 0)
        i += 1
    params = source[m.end():i - 1].strip()
    return [p.strip() for p in params.split(",")] if params else []


@pytest.mark.parametrize("module,symbol,nargs", list(signatures()))
def test_signature_matches_cuda_source(module, symbol, nargs):
    source = (_build.CSRC / f"{module}.cu").read_text()
    params = c_parameters(source, symbol)
    assert params is not None, (
        f'csrc/{module}.cu has no extern "C" int {symbol}(')
    assert len(params) == nargs, (
        f"{symbol}: {len(params)} parameters in csrc/{module}.cu, "
        f"{nargs} argtypes in kernels/{module}.py: {params}")


def test_every_source_is_bound():
    """Every CUDA source the build compiles belongs to one module here."""
    assert set(_build.SOURCES) == set(MODULES)
