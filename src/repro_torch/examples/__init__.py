"""The example programs, ported (the counterparts of the repository's
``examples/``): ``python -m repro_torch.examples.<name>``, on the card by
default and on the CPU with ``--device cpu``.

  quickstart       a hinted workflow through the store and the proactive
                   scheduler, torch bodies on the device, and the paper's
                   scheduler comparison in the simulator
  serve_routed     location-aware routing of follow-ups over two engines
  train_lm         a ~100M-param LM through the training loop, with a
                   simulated failure and a restart from its checkpoint
  elastic_restart  a checkpoint restored onto a new mesh, content checked
"""
