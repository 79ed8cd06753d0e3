"""decode_step_ms: the window's decode host spans (a decode step, its greedy
token and the copy of the tokens to the host), all their time over their
number, in milliseconds."""


def read(run):
    spans = [s for s in run.spans if s.name == "decode"]
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
