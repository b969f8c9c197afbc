from .ops import BLOCK_ROWS, fits, moe_grouped, tile_table

__all__ = ["moe_grouped", "tile_table", "fits", "BLOCK_ROWS"]
