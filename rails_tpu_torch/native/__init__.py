"""The port's C++ host library: the sparse LU behind
``a11_solver="native_lu"`` and ``sinv(method="native_lu")``, and the
MatrixMarket reader of ``rails_tpu_torch.io`` (``host_lib.py``)."""
