from .alist import dump_alist, load_alist, parse_alist, save_alist
from .code import Code, get_code, make_regular_ldpc
from . import gf2

__all__ = [
    "Code",
    "get_code",
    "make_regular_ldpc",
    "gf2",
    "parse_alist",
    "load_alist",
    "dump_alist",
    "save_alist",
]
