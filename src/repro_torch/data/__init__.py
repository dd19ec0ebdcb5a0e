"""Data for the port: numpy-made synthetic stand-ins of the paper's
datasets and the LMs' token batches (``synthetic``), and the background
prefetch onto the device (``pipeline``)."""
