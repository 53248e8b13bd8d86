"""Clustering / spatial algorithms (reference deeplearning4j-core
clustering/ + plot/): the port of `deeplearning4j_tpu/clustering`, with the
same exports. The trees and the t-SNE affinities are host numpy; k-means,
the t-SNE steps and the brute-force k-NN run on the device (CUDA unless the
caller passes `device`)."""
from .kdtree import KDTree
from .kmeans import KMeansClustering
from .tsne import Tsne
from .vptree import VPTree, knn_brute_force
