from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.data.synthetic_squad import SyntheticSquad, Paragraph, Question

__all__ = ["HashTokenizer", "SyntheticSquad", "Paragraph", "Question"]
