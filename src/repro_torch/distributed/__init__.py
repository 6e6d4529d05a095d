"""Data-parallel pieces of the port: the mesh helpers the multi-device fit
needs and the int8 wire compression (``compression``)."""
from .compression import (compress_tree, compressed_grads, decompress_tree, dequantize_int8,
                          init_residuals, quantize_int8)
from .mesh import data_axes, data_group, data_shard, mesh_shape

__all__ = ["compress_tree", "compressed_grads", "data_axes", "data_group", "data_shard",
           "decompress_tree", "dequantize_int8", "init_residuals", "mesh_shape",
           "quantize_int8"]
