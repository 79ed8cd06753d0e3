"""ssm_scan_roofline: the least time of every selective scan the window's
prefills ran (the frozen scan_bound at each prefill's shape, one scan a
layer) over the scan kernel's device time in the trace, in %.  Nothing when
the trace holds no scan kernel or another number of them."""

KERNEL = "ssm_scan_kernel"


def read(run):
    if run.trace is None:
        return None
    ops = [e - s for name, s, e in run.trace["ops"] if KERNEL in name]
    prefills = [s for s in run.spans if s.name == "prefill"]
    m = run.model
    calls = m["n_layers"] * len(prefills)
    if not ops or len(ops) != calls:
        return None
    d = m.get("ssm_expand", 2) * m["d_model"]
    bound = sum(run.counts.scan_bound(b, seq, d, m["ssm_state"])[0] for b, seq in (p.meta["batch"] for p in prefills))
    return 100.0 * bound * m["n_layers"] / (sum(ops) * 1e-9)
