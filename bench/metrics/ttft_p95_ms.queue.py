"""95th percentile of the time to first token (ms) in the traced run,
over every request whose first token fell in its window.  In a closed
loop with one prefill chunk a step it is mostly the wait for that chunk:
the scheduler's queue, read beside serve_tok_s.  A window holds only some
tens of first tokens, too few for an end-to-end tail."""
import numpy as np


def read(run):
    v = run.ttft_ms()
    return float(np.percentile(v, 95)) if v else None
