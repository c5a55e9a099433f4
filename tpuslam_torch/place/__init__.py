from .kfdb import KeyFrameDatabase
from .vocab import BinaryVocabulary, train_vocabulary, vocab_from_numpy
from .orbvoc import load_orbvoc, save_orbvoc_binary, save_orbvoc_text
