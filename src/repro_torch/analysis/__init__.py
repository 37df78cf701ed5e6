"""Reports on census runs: the port's counterpart of the JAX package's
``analysis`` package (so far its streamed-schedule section,
:func:`repro_torch.analysis.report.streaming_section`)."""

from repro_torch.analysis.report import streaming_section

__all__ = ["streaming_section"]
