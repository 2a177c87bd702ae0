"""The tiny CPU sizes of configurations added after `tests/small.py`, whose
table the tests that take every cell read (`small.small`): merged into it
here, before any test module is collected."""

import os
import sys

TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
if TESTS not in sys.path:
    sys.path.insert(0, TESTS)

import small  # noqa: E402

# Every width and depth as published but the bounces (two of six); the image,
# the samples, the interval and the knot's segments and sides cut.
small.SMALL.setdefault("wine_glass_trefoil", {"width": 64, "height": 36, "spp": 2, "interval": 1, "max_bounces": 2,
                                              "mesh": {"segments": 60, "sides": 10}})
