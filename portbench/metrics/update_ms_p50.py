"""The median update time, in milliseconds, of the updates outside the
traced stretch (the harness's clock at each callback)."""

import numpy as np


def read(ctx):
    updates = ctx.updates()
    return float(np.percentile(updates, 50)) * 1e3 if updates else None
