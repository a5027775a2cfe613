"""Native (C++) host-side acceleration.

The reference had no first-party native code — Theano generated it (SURVEY.md
section 3.2). This framework's native tier accelerates the host-side hot
loop SURVEY.md section 4.1 identifies (the window sweep / instance encoding
that must outrun the device), exposed via ctypes with a numpy fallback of
identical semantics (sert_tpu/data/windows.py).
"""
