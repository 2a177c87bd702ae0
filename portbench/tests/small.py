"""Tiny sizes of the configurations for the CPU tests: every width and
depth as published, the image, the samples and the scene's scale cut."""

SMALL = {
    "pegasus_trefoil": {"width": 24, "height": 20, "spp": 2, "mesh": {"segments": 60, "sides": 20},
                        "sky": {"height": 32}},
}


def small(cell: str) -> dict:
    return SMALL[cell.split(".")[0]]
