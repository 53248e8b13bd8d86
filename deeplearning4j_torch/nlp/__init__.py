"""NLP: word/doc/graph embeddings + text pipeline (reference
deeplearning4j-nlp-parent): the port of `deeplearning4j_tpu/nlp`, with the
same exports."""
from .glove import Glove
from .paragraph_vectors import LabelsSource, ParagraphVectors
from .sequence_vectors import SequenceVectors
from .serializer import WordVectorSerializer
from .vectorizers import (ENGLISH_STOP_WORDS, BagOfWordsVectorizer,
                          CnnSentenceDataSetIterator, TfidfVectorizer)
from .word2vec import Word2Vec, WordVectors
from .distributed import ShardedWord2Vec, corpus_arrays
from .vectorizers import Word2VecDataSetIterator
