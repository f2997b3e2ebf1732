"""Command-line launchers of the port.

  serve.py       synthetic concurrent load against ``TendencyServer``
                 (``python -m repro_torch.launch.serve [--smoke] [--device]``)
  chaos.py       scripted fault schedules against the serving layer, with
                 exact resilience-counter pins
                 (``python -m repro_torch.launch.chaos [--smoke] [--device]``)
  train.py       the training CLI over ``train.loop.train`` on one card
                 (``python -m repro_torch.launch.train --arch A [--smoke]
                 [--device cpu]``)
  dryrun.py      every (arch x shape x mesh) cell's step traced on a fake
                 world of 512 ranks: per-rank FLOPs, collectives, bytes
                 (``python -m repro_torch.launch.dryrun --arch A --shape S``)
  perf.py        the named experiments over the dry run's cells
  roofline.py    the analytic workload model and the H100's roofline terms
                 over dry-run records
  mesh.py        production and host meshes (``DeviceMesh``)
  shardspecs.py  batch, train-state and decode-cache shardings
"""
