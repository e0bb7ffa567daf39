"""Scale-envelope abstract interpreter over the port's stage bodies (the
port's counterpart of the reference's ``tpu_swirld/analysis/flow``).

The linter sees syntax and the model checker sees tiny worlds; neither
can answer the question a 1M-event run forces: *can any int32 in the
stage bodies wrap, any gather read out of bounds, any narrowing lose a
value, any padding sentinel collide with live data — at the shapes and
magnitudes the full-scale run actually reaches?*  This package answers
it with machine-checked value flow over the **real stage functions**:

- every stage the drivers dispatch through ``obs.stage_call`` is run on
  ``FakeTensor``s at the declared **scale envelope** shapes (events,
  members, window, round/fork caps — :mod:`.envelope`), so the analysis
  covers exactly the code the card runs, not a guessed AST;
- an **interval × dtype lattice** (:mod:`.lattice`) is propagated
  through every aten op by a transfer-function registry (:mod:`.transfer`)
  that **hard-fails on unknown ops** — there is no silent "assume top"
  unsoundness path;
- the interpreter (:mod:`.interpret`) runs host control flow as Python
  runs it: host loops up to 64 iterations exactly, longer ones by
  join-to-fixpoint and length-aware extrapolation (a round counter over
  1M events proves *rounds ≤ events*, which is the whole envelope
  argument for int32), and host pulls at the values the stage specs
  declare;
- violations become findings in the lint catalog's format and rule
  space — **SW008** overflow-reachable, **SW009** unproven gather/
  scatter bounds, **SW010** lossy narrowing, **SW011** sentinel
  collision — pinpointed to file/line from the Python stack, and
  suppressible per site with ``# swirld-lint: disable=SW00x -- <why>``
  where the justification text is *required*.

The stage bodies reach the CUDA kernels only through the wrappers of
``gpu/kernels.py``, which take their plain versions on the CPU fake
tensors: the audit proves the kernels' contract (an int32 stake tally
under ``check_stake_envelope``), and ``chip_smoke.py``'s phase 18 holds
the card's kernels to it (:func:`.audit.soundness_check` on the card).

CLI::

    python -m tpu_swirld_torch.analysis scale-audit --envelope 1m --device cpu
    python -m tpu_swirld_torch.analysis scale-audit --engine mesh --json
    python -m tpu_swirld_torch.analysis scale-audit --mutate ssm-acc-int16

Exit codes: 0 proven clean, 1 findings, 2 unknown op or undeclared host
pull (the registry refused to guess).
"""

from tpu_swirld_torch.analysis.flow.lattice import AbsVal, Interval  # noqa: F401
from tpu_swirld_torch.analysis.flow.transfer import (  # noqa: F401
    UnknownPrimitiveError,
    registered_primitives,
)
from tpu_swirld_torch.analysis.flow.interpret import (  # noqa: F401
    UndeclaredPullError,
    interpret_stage,
)
from tpu_swirld_torch.analysis.flow.envelope import ScaleEnvelope  # noqa: F401
from tpu_swirld_torch.analysis.flow.audit import (  # noqa: F401
    scale_audit,
    scale_audit_stamp,
    soundness_check,
)

__all__ = [
    "AbsVal",
    "Interval",
    "UnknownPrimitiveError",
    "UndeclaredPullError",
    "registered_primitives",
    "interpret_stage",
    "ScaleEnvelope",
    "scale_audit",
    "scale_audit_stamp",
    "soundness_check",
]
