"""Utilities of the port (``utils.collectives``: the counterpart of the
reference's ``repro/utils/hlo.py``)."""
