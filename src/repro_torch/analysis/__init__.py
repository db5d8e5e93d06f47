"""Static analysis of the port: the quantized-coverage audit of a real
training step, the numerics lint and the kernel verifier over the CUDA
kernels' launch descriptors.  CLI: ``python -m repro_torch.analysis.audit
--help``.

Nothing is imported here, so that ``kernels`` can import
:mod:`.intervals` without loading the rest.
"""
