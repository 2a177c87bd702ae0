"""The 95th percentile, in milliseconds, of the time between successive
progress callbacks (the first of a frame from the frame's start) over every
update of the window, by the host's clock."""

import numpy as np


def read(ctx):
    updates = ctx.updates()
    return float(np.percentile(updates, 95)) * 1e3 if updates else None
