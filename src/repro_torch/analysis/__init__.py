"""Analysis of census runs and of the LM dry runs: the port of the JAX
package's ``analysis`` package.  ``report`` renders the markdown
sections, ``roofline`` the three-term roofline on the H100, and
``collectives`` models the per-device collective schedule of a step (the
counterpart of the reference's HLO parser)."""

from repro_torch.analysis.collectives import collective_schedule
from repro_torch.analysis.report import (
    dryrun_section, roofline_section, streaming_section, variants_section)
from repro_torch.analysis.roofline import (
    RooflineRow, analytic_hbm_bytes, analyze_record, fmt_seconds,
    load_records, markdown_table, model_flops)

__all__ = ["streaming_section", "dryrun_section", "roofline_section",
           "variants_section", "RooflineRow", "analyze_record",
           "analytic_hbm_bytes", "model_flops", "load_records",
           "fmt_seconds", "markdown_table", "collective_schedule"]
