"""The plain reference a configuration names, and what it supplies.

A configuration file (``configs/<config>.json``) names its plain reference
in its top-level ``"reference"`` key: a module file ``<reference>.py`` of
the reference directory (``simbench/reference/``), loaded by path (`load`).
The harness, the host plane, the rounds and the metric readers reach an
architecture's code only through that module, so a new architecture is a
new module file beside its configuration.  A module supplies:

- ``make_arch(model)``: the architecture, a frozen type of the module's
  own built from the configuration's ``model`` dict; a key the module does
  not read raises and names the key (`frozen_arch`).
- ``leaf_specs(arch)``: the initial units' layout, ``[(unit, path, shape,
  dtype, init)]`` in the simulator's sorted-key order, ``init`` a normal's
  standard deviation (drawn), ``"zeros"``, ``"ones"`` or a callable
  ``init(shape, dtype, device)`` of the module's own that draws nothing
  (`params.make_units`).
- ``loss(units, batch, arch, quant)``: one client's mean loss on one batch,
  ``quant`` a control's rounding of every product's operands.
- ``train_data(arch, traffic, seed)``: the training arrays by name
  (``labels`` among them) and the labels the non-IID partition sorts by.
- ``n_labels(arch)``: the labels' range (the ``label`` fault moves a label
  by one within it).
- ``client_specific(arch, cuts, n_units)``: per unit, whether a decision's
  ``cuts`` keep it on the clients (Eq. 7 units) or on the server (Eq. 4).
- ``unit_layer_spans(arch, n_units, n_layers)``: each unit's ``(lo, hi)``
  span of the HASFL profile's layers, over which the online estimate
  spreads the unit's gradient moments.
- the work counts the metric readers take from the widths, each None where
  the architecture has no such layer: ``train_flops(arch, samples, seq,
  causal_half=True)`` (a training step's products over ``samples`` useful
  samples, `mfu`); ``conv_gemm_flops(arch)`` (a sample's convolution GEMM
  FLOPs, `k1_gemm_roofline`); ``attention_calls(arch)`` (the attention
  calls of a forward) with ``attention_call_costs(arch, rows, seq,
  causal_half=True, itemsize=2)`` (a call's forward and backward operations
  and bytes, `attn_roofline`); ``norms_per_step(arch)`` (the norms of a
  forward) with ``norm_call_bytes(arch, tokens, clients, itemsize=2)`` (a
  norm's forward and backward bytes, `rmsnorm_roofline`).  Where a count
  is not None, the module's ``attention(q, k, v)`` or ``rmsnorm(x, scale,
  eps)`` is the layer it counts, called once a call by ``loss``.
- the tests' CPU size: ``SMALL`` (``program_arch``, the program's
  registered architecture the small one derives from; ``model`` and
  ``traffic``, the keys a small cell overrides; ``counts``, the keys the
  count tests override) and ``example_batch(arch, rows, seq, generator)``.
"""
from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

REQUIRED = ("make_arch", "leaf_specs", "loss", "train_data", "n_labels",
            "client_specific", "unit_layer_spans", "train_flops",
            "conv_gemm_flops", "attention_calls", "norms_per_step", "SMALL",
            "example_batch")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_-]{0,63}")


def load(name, directory: Path):
    """The reference module ``<directory>/<name>.py``, by path."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"reference {name!r} is not a module name")
    path = Path(directory) / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"reference {name!r}: {path} is missing")
    mod_name = f"simbench_reference_{name.replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    missing = [n for n in REQUIRED if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f"{path} does not supply {missing}")
    return mod


def frozen_arch(cls, model: dict, reads, module_file: str):
    """``cls(**model)`` (lists as tuples), refusing every key of ``model``
    outside ``reads``, the keys the module reads."""
    extra = sorted(set(model) - set(reads))
    if extra:
        raise ValueError(f"{Path(module_file).name} does not read the model "
                         f"key(s) {extra}")
    return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in model.items()})
