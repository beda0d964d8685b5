"""Titanic survival, the canonical end-to-end flow (counterpart of
``transmogrifai_tpu.examples.titanic``, the same definitions): typed raw
features from a headerless CSV, two derived features, ``transmogrify``,
SanityChecker, ``BinaryClassificationModelSelector`` with 3-fold
cross-validation over its default model list, ``OpWorkflow.train``.

    from transmogrifai_tpu_torch.examples.titanic import build_workflow
    wf, survived, prediction = build_workflow("passengers.csv")
    model = wf.train()                 # on the CUDA device
    model.score()                      # the reader's rows, keyed by id

``testing.titanic_csv`` writes a seeded synthetic file in this schema.
"""
from __future__ import annotations

from typing import Tuple

from ..features import Feature, FeatureBuilder
from ..impl.feature.transmogrifier import transmogrify
from ..impl.preparators.sanity_checker import SanityChecker
from ..impl.selector.factories import BinaryClassificationModelSelector
from ..readers import DataReaders
from ..stages.base import BinaryTransformer
from ..types import Real
from ..workflow import OpWorkflow

TITANIC_SCHEMA = ["PassengerId", "Survived", "Pclass", "Name", "Sex", "Age",
                  "SibSp", "Parch", "Ticket", "Fare", "Cabin", "Embarked"]


def titanic_features() -> Tuple[Feature, Feature]:
    """(survived, feature vector): the JAX package's definitions, built in
    the same order, so after ``features.reset_uids()`` every stage has the
    uid the JAX package gives it after its own."""
    survived = FeatureBuilder.RealNN("Survived").extract_field().as_response()
    p_class = FeatureBuilder.PickList("Pclass").extract(
        lambda r: None if r.get("Pclass") is None else str(r.get("Pclass"))
    ).as_predictor()
    name = FeatureBuilder.Text("Name").extract_field().as_predictor()
    sex = FeatureBuilder.PickList("Sex").extract_field().as_predictor()
    age = FeatureBuilder.Real("Age").extract_field().as_predictor()
    sib_sp = FeatureBuilder.Integral("SibSp").extract_field().as_predictor()
    par_ch = FeatureBuilder.Integral("Parch").extract_field().as_predictor()
    ticket = FeatureBuilder.PickList("Ticket").extract_field().as_predictor()
    fare = FeatureBuilder.Real("Fare").extract_field().as_predictor()
    cabin = FeatureBuilder.PickList("Cabin").extract_field().as_predictor()
    embarked = FeatureBuilder.PickList("Embarked").extract_field(
    ).as_predictor()
    family_size = sib_sp.transform_with(
        BinaryTransformer("familySize",
                          lambda s, p: (s or 0) + (p or 0) + 1, Real), par_ch)
    estimated_cost = family_size.transform_with(
        BinaryTransformer("estCost",
                          lambda f, fare_v: (f or 0) * (fare_v or 0.0), Real),
        fare)
    feature_vector = transmogrify([
        p_class, name, sex, age, sib_sp, par_ch, ticket, fare, cabin,
        embarked, family_size, estimated_cost])
    return survived, feature_vector


def build_workflow(csv_path: str, seed: int = 42, models=None, device=None
                   ) -> Tuple[OpWorkflow, Feature, Feature]:
    """(workflow, survived, prediction) over the headerless CSV at
    ``csv_path``, keyed by ``PassengerId``; ``models`` pins the selector's
    model list (None: the default list), ``device`` the workflow's."""
    survived, feature_vector = titanic_features()
    checked = survived.transform_with(SanityChecker(seed=seed),
                                      feature_vector)
    prediction = survived.transform_with(
        BinaryClassificationModelSelector.with_cross_validation(
            seed=seed, models=models), checked)
    reader = DataReaders.Simple.csv(csv_path, schema=TITANIC_SCHEMA,
                                    header=False, key_field="PassengerId")
    wf = (OpWorkflow(device=device)
          .set_reader(reader)
          .set_result_features(prediction, checked))
    return wf, survived, prediction
