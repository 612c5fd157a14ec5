"""The port's renderer (``mdapy_tpu/render`` on PyTorch).

Submodules are imported explicitly (``mdapy_tpu_torch.render.render`` and
so on); this package imports nothing at load time.
"""
