"""Seconds of the harness's first import of the program's CLI and engine
(and with them torch), in a process that had loaded neither."""

LAYER = "start-up"
UNIT = "s"
MOVES = "setup_s"


def read(record: dict):
    return record.get("import_s")
