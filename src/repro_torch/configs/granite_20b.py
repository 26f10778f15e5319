"""granite-20b [dense] — granite-34b geometry at 52 layers. [arXiv:2405.04324; hf]"""
from ..models.config import ArchConfig
from . import granite_34b


def config() -> ArchConfig:
    return granite_34b.config().replace(name="granite-20b", n_layers=52)


def smoke() -> ArchConfig:
    return granite_34b.smoke().replace(name="granite-20b", n_layers=2)
