"""paddle_tpu_torch.analysis — the port of ``paddle_tpu/analysis``: the
serving stack's hand-pinned contracts as checks, read off what the port
runs (the reference reads jaxprs and HLO; the port compiles nothing).

- :mod:`.tracecheck` — :class:`CompileGuard` (signature counting,
  budgets, retrace explanation, donation checks), :func:`donation_audit`
  and :class:`SyncTally` (the host's reads of the device, on the card
  with torch's sync debug mode). The engine's ``compile_counts`` reads
  off its guards; ``ServingConfig(debug_checks=True)`` turns the audits
  on at every step.
- :mod:`.hlocheck` — one executed step audited: the collective census
  against a declared :class:`CollectiveBudget`, host reads inside the
  device program, the pools written in place, and :func:`.hlocheck.
  step_cost`'s flops and bytes.
- :mod:`.meshcheck` — the census placed on a declared
  :class:`MeshTopology` (NVLink within a host, the network across),
  per-medium budgets and a link-time model.
- :mod:`.kernelcheck` — the CUDA kernels' launch plans certified:
  shared memory and registers within the H100's budget, output maps
  injective over the grid, the plan equal to the C launch on the card,
  a banked roofline, the dispatch coverage.
- :mod:`.lint` — the reference's rules as they read in PyTorch, with
  ``# lint: disable=PTxxx`` pragmas; ``paddle_tpu_torch/`` lints clean.
- :mod:`.check_all` — every engine back to back, one exit code
  (``python -m paddle_tpu_torch.analysis all``).
"""
from .hlocheck import (SINGLE_CHIP, AliasingViolation,  # noqa: F401
                       CollectiveBudget, CollectiveBudgetError,
                       HloAuditReport, HloCheckError, HostTransferError)
from .kernelcheck import (KernelBudget, KernelCertReport,  # noqa: F401
                          KernelCheckError, KernelFinding)
from .kernelcheck import certify as certify_kernel  # noqa: F401
from .lint import (ALLOWLIST, RULES, Finding, lint_paths,  # noqa: F401
                   lint_source)
from .meshcheck import (MeshCheckError, MeshReport,  # noqa: F401
                        MeshTopology, multi_host_topology,
                        single_host_topology)
from .meshcheck import analyze as analyze_mesh  # noqa: F401
from .tracecheck import (CompileGuard, DonationViolation,  # noqa: F401
                         RetraceError, SyncTally, SyncViolation,
                         abstract_signature, donation_audit,
                         explain_signature_diff, sync_tally_paused)

__all__ = ["CompileGuard", "RetraceError", "DonationViolation",
           "SyncViolation", "SyncTally", "donation_audit",
           "abstract_signature", "explain_signature_diff",
           "sync_tally_paused",
           "CollectiveBudget", "HloAuditReport", "HloCheckError",
           "CollectiveBudgetError", "HostTransferError",
           "AliasingViolation", "SINGLE_CHIP",
           "KernelBudget", "KernelCertReport", "KernelCheckError",
           "KernelFinding", "certify_kernel",
           "MeshTopology", "MeshReport", "MeshCheckError",
           "single_host_topology", "multi_host_topology", "analyze_mesh",
           "Finding", "RULES", "ALLOWLIST", "lint_source", "lint_paths"]
