"""roofline.fermi_density (%): the job of the SCC's occupations and density
(the Fermi fill and P = C diag(f) C^T, each loop iteration of each batch)
against its bound: the bound's seconds (`harness/bounds.py`
`fermi_density_bound_s`, from the batch's shape) times the launches the
program's tally counted in the traced steps (`ops/fermi_fill`
`density_launches`, one per iteration), over the device seconds the trace
gives the kernels that do this job. The job's kernels: the fused kernel's
entries (`csrc/fermi_fill.cu` `fermi_density_packed`,
`fermi_density_warps`)."""

from benchmark.harness import bounds, trace

#: the kernels that do the job, by name
KERNELS = ("fermi_density_packed", "fermi_density_warps")


def _match(name):
    return any(k in name for k in KERNELS)


def read(run):
    if run.trace is None:
        return None
    bound = 0.0
    for ch in run.chunks:
        n = run.traced_launches.get(ch["name"], {}).get("density", 0)
        bound += n * bounds.fermi_density_bound_s(
            ch["fragments"], ch["nao"], ch["itemsize"], ch["open_shells"])
    device = trace.kernel_seconds(run.trace, _match)
    if bound <= 0:
        return None
    if device <= 0:
        # the program launched the job but no traced kernel bears a name
        # above: the names are wrong, and the share must not go silent
        raise RuntimeError("roofline.fermi_density: launches counted, but no "
                           "traced kernel matches the job's names")
    return 100.0 * bound / device
