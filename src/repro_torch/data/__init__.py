"""The input pipeline (the port of ``repro.data``)."""
