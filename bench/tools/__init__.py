"""Measurements made once, when a cell is defined: not part of a run."""
