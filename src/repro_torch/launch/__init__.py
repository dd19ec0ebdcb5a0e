"""Command-line entry points of the port (``python -m repro_torch.launch.serve``,
``train``, ``dryrun``, ``roofline``) and the accounting behind the last
two (``cells``, ``comm_analysis``)."""
