"""Command-line front door of the port: the sweep runner (``benchmark``),
the ring kernels' timer (``time_ring_kernels``) and the observatory's
reports (``observatory_report``, ``calib_report``, ``sim_report``,
``sweep_dash``), each run as ``python -m ddlb_tpu_torch.cli.<name>``."""
