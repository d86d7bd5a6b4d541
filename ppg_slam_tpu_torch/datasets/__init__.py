from .loaders import load_euroc, load_tumvi, load_uma
from .png import read_gray, write_png

__all__ = ["load_euroc", "load_tumvi", "load_uma", "read_gray", "write_png"]
