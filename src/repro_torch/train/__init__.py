"""Training: AdamW, the train step, checkpoints and the loop (the port of
``repro.train``; ``elastic.py`` waits for the port of ``dist/``)."""
