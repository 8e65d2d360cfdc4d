"""Rule registry for the graft-lint AST pass (counterpart of
``metrics_tpu/analysis/rules/__init__.py``).

Every rule object exposes ``rule_id`` / ``name`` / ``description`` and a
``check(module: ModuleSource) -> Iterable[Finding]``. IDs are stable API —
suppression comments and baseline entries reference them, and they are the
JAX package's:

==========  ==================  ====================================================
rule id     family              what it catches
==========  ==================  ====================================================
``GL000``   (engine)            file failed to parse (syntax error)
``GL101``   import purity       module-scope CUDA discovery call
                                (``torch.cuda.is_available`` and friends) — opens
                                CUDA at import
``GL102``   import purity       module-scope call that makes a CUDA tensor or
                                builds/loads a kernel (``ops/_build.py``)
``GL301``   state discipline    direct ``_state``/``_defaults`` writes outside
                                ``add_state``
``GL302``   state discipline    list ('cat') state declared without ``template=``
``GL401``   concurrency         ``threading.Thread`` without both ``daemon=`` and
                                ``name=``
``GL402``   concurrency         listener/callback/hook invoked while a lock is
                                held (call outside the lock)
``GL403``   concurrency         lock attribute created outside a construction-path
                                method (lazy minting races its own creation)
``GL501``   contract            ``os.environ``/``os.getenv`` read outside
                                ``ops/_envtools.py`` (the EnvParse contract)
``GL502``   contract            write-mode ``open()`` bypassing
                                ``resilience/snapshot.py::atomic_write_bytes``
``GL503``   contract            unconditional ``record_degradation`` in a loop
                                body (cadence-rate spam; gate behind an episode)
==========  ==================  ====================================================

The JAX package's trace-safety family (``GL201``-``GL203``: Python casts,
``.item()`` and host clocks inside a jitted update) is not ported (ROADMAP
D69): the port has no tracer. Its counterpart runs the step: the graph
audit's recorder of aten ops (``analysis/graph_audit.py``) flags a read to
the host, a float64 op and a value-shaped op in a registry entry's step.

The static lock-order pass (cycles + hierarchy manifest) is not a per-module
rule — it is whole-package by construction and lives in
:mod:`metrics_tpu_torch.analysis.concurrency` (``python -m
metrics_tpu_torch.analysis locks``).
"""
from typing import Dict, Tuple

from metrics_tpu_torch.analysis.rules.concurrency_discipline import (
    BareThread,
    CallbackUnderLock,
    LockCreatedOutsideInit,
)
from metrics_tpu_torch.analysis.rules.contract_discipline import (
    BareWriteOpen,
    EnvReadOutsideEnvtools,
    UngatedHealthEventInLoop,
)
from metrics_tpu_torch.analysis.rules.import_purity import CudaWorkAtImport, DeviceDiscoveryAtImport
from metrics_tpu_torch.analysis.rules.state_discipline import DirectStateWrite, ListStateWithoutTemplate

ALL_RULES: Tuple = (
    DeviceDiscoveryAtImport(),
    CudaWorkAtImport(),
    DirectStateWrite(),
    ListStateWithoutTemplate(),
    BareThread(),
    CallbackUnderLock(),
    LockCreatedOutsideInit(),
    EnvReadOutsideEnvtools(),
    BareWriteOpen(),
    UngatedHealthEventInLoop(),
)


def rule_catalog() -> Dict[str, str]:
    """rule_id -> one-line description (the CLI ``rules`` listing)."""
    return {rule.rule_id: rule.description for rule in ALL_RULES}
