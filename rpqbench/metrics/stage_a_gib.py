"""Bytes of the Stage-A tile store staged on the device by the end of
set-up (the plan store's ``tile_store_stats``), in GiB."""

UNIT, LAYER, MOVES, SOURCE = "GiB", "Stage A", "setup_s", "program_counter"


def read(run):
    return run.staged_bytes / 2**30 if run.staged_bytes else None
