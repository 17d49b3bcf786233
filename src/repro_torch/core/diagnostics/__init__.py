from repro_torch.core.diagnostics.tools import (DiagnosticMonitor, FailureInjector,  # noqa: F401
                                          FaultKind, Telemetry)
