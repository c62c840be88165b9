"""The host side's native batch prep: the JOSE parse, SHA-2, record
packing and claims parse in multithreaded C++ (``native/``), built by
``cap_tpu_torch._build`` at first use and bound in ``native_binding``.
"""
