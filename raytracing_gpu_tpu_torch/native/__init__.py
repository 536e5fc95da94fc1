"""The native (C++) host library: the `.svati` tokenizer and the PPM / PNG
writers, with a plain C interface loaded through ctypes.

The port's own copies of the JAX package's `native/` sources. The Python
parser and writers stay the semantic definition and the fallback; each
native path is held byte- or bit-identical to its Python twin
(tests/test_torch_native.py). Built with g++ at first use into
`raytracing_gpu_tpu_torch/_build/native-<hash>/` (`native/build.py`);
RGT_NATIVE=0 turns the native paths off.
"""
