"""ML-framework integration: sklearn-style estimators (reference
dl4j-spark-ml's Spark ML Estimator/Model wrappers —
Spark ML is JVM infrastructure; the behavioral role is 'this framework's
nets as citizens of the host ecosystem's ML pipeline API', which in the
Python world is the scikit-learn estimator contract)."""
from .estimator import MLNClassifier, MLNRegressor
