"""Data for the port: numpy-made synthetic stand-ins of the paper's
datasets (``synthetic``)."""
