"""repro_torch.roofline — the three-term roofline at the H100's constants
(port of `repro.roofline`)."""
from .analysis import (HBM_BW, LINK_BW, PEAK_FLOPS, Costs, analytic_costs,
                       full_table, load_dryrun, markdown_table,
                       params_active, params_total, roofline_terms)

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "Costs", "analytic_costs",
           "full_table", "load_dryrun", "markdown_table", "params_active",
           "params_total", "roofline_terms"]
