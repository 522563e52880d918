from .generate import (  # noqa: F401
    generate, generate_hf, generate_seq2seq, generate_multimodel)
from .sampling import (  # noqa: F401
    LogitsProcessor, GreedyProcessor, MultinomialProcessor, TopKProcessor,
    NucleusProcessor, TopKNucleusProcessor, MinPProcessor,
    apply_repetition_penalty,
    apply_no_repeat_ngram, apply_min_new_tokens,
    apply_suppress_tokens, apply_forced_token)
from .stopping import (  # noqa: F401
    KeywordsStoppingCriteria, generate_until)
