"""Analysis tools for the consensus core (the port's counterpart of the
reference's ``tpu_swirld/analysis`` package).

Consensus safety is "decided prefixes bit-identical across nodes", so
these tools hold the code to determinism: no unseeded RNG, no
hash-randomized ``set`` iteration and no wall-clock read on a consensus
path.

What the port has:

- :mod:`tpu_swirld_torch.analysis.mc` — the explicit-state model checker:
  every gossip/delivery interleaving of a small world through the real
  oracle node, an invariant catalog, seeded mutations, and ddmin-minimized
  counterexample documents that replay in either package.

CLI::

    python -m tpu_swirld_torch.analysis mc [--n N] [--events N] [--mutate NAME]

The reference's invariant linter (``lint`` and its ``rules``), race
sanitizer (``races``) and jaxpr tools (``jit-audit``, ``scale-audit``) are
not in the port; the dispatcher names the ROADMAP item of each.
"""
