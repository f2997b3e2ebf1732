"""Command-line launchers of the port.

  serve.py   synthetic concurrent load against ``TendencyServer``
             (``python -m repro_torch.launch.serve [--smoke] [--device]``)
  chaos.py   scripted fault schedules against the serving layer, with
             exact resilience-counter pins
             (``python -m repro_torch.launch.chaos [--smoke] [--device]``)
"""
