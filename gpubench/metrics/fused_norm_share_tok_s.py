"""Share of the slice's RMSNorm sites that K12 ran, one launch a site with
its residual add (engine counters ``norm_sites_fused`` / ``norm_sites``,
added as each decode tick and prefill call is launched). None where the
program has no such counters, ran no norm site in the slice, or did not
run on the card (a trace with no kernel: on the CPU every site takes the
plain version by design)."""

from ._tokens import delta

NAME, UNIT, SOURCE = "fused_norm_share.tok_s", "%", "program_counter"
LAYER, MOVES = "kernel K12 (RMSNorm)", "output_tok_s"
KERNELS = ()


def read(run, trace, cell):
    sites, fused = delta(run, "norm_sites"), delta(run, "norm_sites_fused")
    if not sites or fused is None or not (trace and trace["kernels"]):
        return None
    return 100.0 * fused / sites
