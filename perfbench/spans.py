"""The program's spans (``gan_rl_3d_tpu_torch/utils/profiling.py``) as the
per-layer metrics read them, in the measuring process of a traced run.

A layer's device time is the time of the device operations launched
inside its span: every operation is matched to the host call that
launched it (one stream, so the device runs them in launch order), and
the launch is placed in the innermost span whose host range holds it. The
span's own CUDA events are not used here: they measure the stream's time
between them, which in the profiled pass includes the idle time the
profiler's host work opens inside a host-paced stretch. Forward spans are
``record_function`` ranges of the trace; a backward segment, which has no
range, is placed on the trace's clock by its ``ae.backward`` parent.

The records hold exactly the profiled pass (set-up, the warm-up pass and
the untraced pass run with the profiler off). A program without spans, a
run whose records carry no device seconds (no card), or a trace whose
launches do not match its device operations one to one gives nothing to
read, and the readers return None.
"""

import bisect
import re
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence

# host runtime calls that put one operation on the device
LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|Memcpy|Memset)")
PREFIXES = ("serve.", "ae.", "setup.")


def _profiling():
    from gan_rl_3d_tpu_torch.utils import profiling

    return profiling


def records() -> List[dict]:
    """The span records of the profiled pass, or [] where there are none
    with device seconds."""
    read = getattr(_profiling(), "span_records", None)
    recs = read() if read is not None else []
    if not any(r.get("device_s") is not None for r in recs):
        return []
    return recs


def totals() -> Dict[str, dict]:
    """Count and host seconds of every span name over the whole process
    (set-up included)."""
    read = getattr(_profiling(), "span_totals", None)
    return read() if read is not None else {}


def _intervals(tr, recs: List[dict]) -> Optional[List[tuple]]:
    """(start, end, name) on the trace's clock of every span range and
    backward segment, sorted by start."""
    ranges = [h for h in tr.host if h[2].startswith(PREFIXES)]
    out = list(ranges)
    parents = [h for h in ranges if h[2] == "ae.backward"]
    back = [r for r in recs if r["name"] == "ae.backward"]
    if len(parents) != len(back):
        return None
    by_request = {r["request"]: (r, h) for r, h in zip(back, parents)}
    for r in recs:
        if r.get("phase") != "backward":
            continue
        if r["request"] not in by_request:
            return None
        parent, host = by_request[r["request"]]
        start = r["t_start"] - parent["t_start"] + host[0]
        out.append((start, start + r["host_s"], r["name"]))
    return sorted(out)


def layer_seconds(ctx) -> Optional[tuple]:
    """(device seconds of the traced pass by the innermost span that
    launched them, None for outside every span; the number of ranges or
    segments of each span name)."""
    recs = records()
    tr = ctx.get("trace")
    if not recs or tr is None:
        return None
    launches = sorted(start for start, _, name in tr.host
                      if LAUNCH.match(name))
    if len(launches) != len(tr.device):
        return None
    spans = _intervals(tr, recs)
    if spans is None:
        return None
    starts = [s for s, _, _ in spans]
    seconds: Dict[Optional[str], float] = defaultdict(float)
    for t, (d0, d1, _) in zip(launches, tr.device):
        name = None
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if spans[j][1] >= t:
                name = spans[j][2]
                break
        seconds[name] += d1 - d0
    return seconds, Counter(n for _, _, n in spans)


def ms_per(ctx, parent: str, names: Sequence[str]) -> Optional[float]:
    """Device milliseconds of the operations launched in the spans named
    ``names``, forward and backward segments alike, per ``parent`` span
    (a served call or a training step)."""
    got = layer_seconds(ctx)
    if got is None or not got[1][parent]:
        return None
    seconds, counts = got
    return 1e3 * sum(seconds[n] for n in names) / counts[parent]
