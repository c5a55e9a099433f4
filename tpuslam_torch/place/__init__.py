from .kfdb import KeyFrameDatabase
from .vocab import BinaryVocabulary, train_vocabulary, vocab_from_numpy
