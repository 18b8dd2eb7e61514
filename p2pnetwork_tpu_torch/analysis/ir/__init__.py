"""graftaudit for the port: the lowering registry, its rules, the cost and
memory ratchets and the carry audit (the port's counterpart of
``p2pnetwork_tpu/analysis/ir/``), beside the memory planner
(``capacity.py``) and its coefficients fitted on the card
(``membudgets.json``).

The reference audits what its lowerings compile to. The port runs eager
torch, so graftaudit runs each lowering once at a 1k shape-class and
audits its census (``census.py``): the torch calls it makes, the bytes
they touch, its host reads and uploads, and each hand-written kernel as
its launches, whichever twin runs, so the census is the same on the CPU
and on the card. Five planes, one CLI
(``python -m p2pnetwork_tpu_torch.analysis.ir``):

- **Lowering registry** (:mod:`.registry`): every propagation variant x
  shape-class, under the reference's names, plus the segment-sum
  kernel's routes.
- **Rules** (:mod:`.rules`): unplanned host syncs, f64 widening, the
  frontier slot budget, and the output-signature parity gate.
- **Cost ratchet** (:mod:`.budgets`): launches, kernel launches, syncs,
  uploads and the ring's exchanges held exactly, bytes within a
  tolerance, in the checked-in ``budgets.json``.
- **Carry audit** (:mod:`.donation`): no engine loop keeps two carries
  (the property the reference's donation audit protects).
- **Memory ratchet** (:mod:`.memory`): each lowering's peak live bytes in
  ``membudgets.json``, cross-checked against a walk of the census.

Findings ride graftlint's ``Finding`` records and baseline. Importing
this package imports no torch: the names below load on first use.
"""

__all__ = ["Lowering", "Trace", "all_lowerings", "shape_class",
           "trace_lowering"]


def __getattr__(name):
    # Lazy re-exports (PEP 562): `python -m ...analysis.ir --list-rules`
    # and the planner's readers need no torch.
    if name in __all__:
        from p2pnetwork_tpu_torch.analysis.ir import registry

        return getattr(registry, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
