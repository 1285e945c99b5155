"""Invariant guard: the project-native static-analysis suite of the port.

The serving stack's hardest-won properties — the zero-sync hot loop, the
fleet < gateway < engine < writer < cache < observatory lock order, the
CUDA sources' rounding disciplines, the never-flickering record schema —
hold only if they are checked mechanically at every site. This package is
that check, exposed as ``heat-tpu-torch check``.

Six rule families (one module each, registered into
``core.RULE_FAMILIES``):

======================  ===================================================
``hot-path-purity``     no host syncs (``.item()``, ``.cpu()``,
                        ``.numpy()``, ``.tolist()``, ``synchronize``) or
                        eager fetches in the serve dispatch paths outside
                        the allow-marked seams
``lock-discipline``     the rank order, no I/O/device work under the
                        engine lock (static half; ``HEAT_TPU_LOCKCHECK=1``
                        arms the dynamic watchdog in ``runtime/debug.py``)
``traced-determinism``  no clocks/entropy/env/set-iteration reachable from
                        a kernel launch or its plain version
``cuda-kernel-safety``  the CUDA sources' disciplines: ``-fmad=false``,
                        explicit ``__fmaf_rn`` updates, selects not
                        multiply-masks, storage rounding every lane step,
                        every header shipped and hashed
``record-schema``       every ``json_record`` site statically resolved and
                        gated against ``analysis/schemas/records.json``
``races``               Eraser-style lockset inference over the thread-
                        shared serving objects, gated against
                        ``analysis/schemas/guards.json`` (static half;
                        ``HEAT_TPU_RACECHECK=1`` arms the dynamic
                        sanitizer in ``runtime/debug.py``)
======================  ===================================================

Sanctioned exceptions carry ``# heat-tpu: allow[rule-id] reason`` markers
next to the code (``// heat-tpu: ...`` in a CUDA source; reason
mandatory). Markers that no longer suppress anything are reported as
stale (``check`` warns; ``--strict-allows`` fails), and ``check
--dead-code`` lists public functions outside the reachability closure
(``deadcode``). The suite reads a tree it never imports: it runs in
seconds with no card.

A second, separate tier — the **program auditor** (``programs``, exposed
as ``heat-tpu-torch audit``) — checks contracts no source lint can see by
dispatching every registered program family for real, at a small shape:
no host sync in a dispatch, the double buffer and the rollback snapshot's
storage, dtype discipline, and the kernel launch-key budget. It needs
torch (and, by default, a card), so it is NOT imported here.
"""

from . import (cuda_rules, deadcode, determinism, locks,  # noqa: F401
               purity, races, schema)
from .core import (RULE_DOCS, RULE_FAMILIES, Context, Violation,  # noqa: F401
                   run_checks)
