"""The int8 weight products of the decode path (see quant_product.py)."""

from portbench.work.quant_product import work  # noqa: F401
