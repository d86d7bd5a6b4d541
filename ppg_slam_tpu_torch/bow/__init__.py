from .vocabulary import Vocabulary

__all__ = ["Vocabulary"]
