"""CAMP numerics: quantization primitives and the ``camp_matmul`` API."""
