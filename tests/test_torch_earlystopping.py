"""The port's early stopping against the JAX package's
(``tests/test_training_infra.py::TestEarlyStopping``): the same data
and carried weights through both trainers give the same termination
reason, total epochs and best epoch, and score lists within 1e-5
relative (f32 GEMMs summed in another order over a few Adam epochs).
"""
import jax
import numpy as np
import pytest

from deeplearning4j_tpu import earlystopping as JES
from deeplearning4j_tpu.datasets import ArrayDataSetIterator as JIter
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu.nn import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu_torch import earlystopping as ES
from deeplearning4j_tpu_torch.convert import network_params_from_jax
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.nn import (MultiLayerNetwork,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn import layers as TL

SCORE_RTOL = 1e-5


def _conf(side, lr=0.05, seed=0):
    Conf, L, Opt = (JConf, JL, JAdam) if side == 0 else \
        (NeuralNetConfiguration, TL, Adam)
    return (Conf.builder().seed(seed).updater(Opt(lr))
            .weight_init("xavier").list()
            .layer(L.DenseLayer(n_out=16, activation="relu", name="feat"))
            .layer(L.OutputLayer(n_out=2, loss="mcxent",
                                 activation="softmax", name="head"))
            .input_type_feed_forward(4).build())


def _pair(**kw):
    jn = JNet(_conf(0, **kw)).init()
    tn = MultiLayerNetwork(_conf(1, **kw), device="cpu").init()
    tn.set_params(network_params_from_jax(
        jax.tree.map(np.asarray, jn.params())))
    return jn, tn


def _data(n=96, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 4).astype(np.float32)
    Y = np.eye(2, dtype=np.float32)[(X[:, 0] + X[:, 1] > 0).astype(int)]
    return X, Y


def _fit_both(X, Y, batch, conditions, savers=(None, None), **kw):
    """The same early-stopping run through JAX's trainer and the
    port's; ``conditions(module)`` builds each side's conditions."""
    jn, tn = _pair(**kw)
    results = []
    for mod, it, net, saver in ((JES, JIter, jn, savers[0]),
                                (ES, ArrayDataSetIterator, tn, savers[1])):
        cfg = mod.EarlyStoppingConfiguration(
            score_calculator=mod.DataSetLossCalculator(it(X, Y, batch=batch)),
            epoch_termination_conditions=conditions(mod),
            model_saver=saver)
        results.append(mod.EarlyStoppingTrainer(
            cfg, net, it(X, Y, batch=batch)).fit())
    jr, tr = results
    assert tr.termination_reason == jr.termination_reason
    assert tr.total_epochs == jr.total_epochs
    assert tr.best_model_epoch == jr.best_model_epoch
    np.testing.assert_allclose(tr.score_vs_epoch, jr.score_vs_epoch,
                               rtol=SCORE_RTOL)
    return jr, tr


class TestEarlyStopping:
    def test_stops_on_max_epochs_and_restores_best(self):
        X, Y = _data()
        jr, tr = _fit_both(
            X, Y, 32, lambda m: [m.MaxEpochsTerminationCondition(8)],
            (JES.InMemoryModelSaver(), ES.InMemoryModelSaver()))
        assert tr.total_epochs == 8
        assert tr.termination_reason == "MaxEpochsTerminationCondition"
        assert len(tr.score_vs_epoch) == 8
        assert tr.best_model_score == min(tr.score_vs_epoch)
        rescore = ES.DataSetLossCalculator(
            ArrayDataSetIterator(X, Y, batch=32)).calculate_score(
            tr.best_model)
        assert rescore == pytest.approx(tr.best_model_score, rel=1e-4)

    def test_patience_condition(self):
        X, Y = _data(48)
        # lr=0: no improvement ever, so patience stops it quickly
        jr, tr = _fit_both(
            X, Y, 24, lambda m: [
                m.ScoreImprovementEpochTerminationCondition(patience=2),
                m.MaxEpochsTerminationCondition(50)], lr=0.0)
        assert tr.total_epochs <= 5
        assert "ScoreImprovement" in tr.termination_reason

    def test_best_score_target(self):
        X, Y = _data()
        jr, tr = _fit_both(
            X, Y, 32, lambda m: [
                m.BestScoreEpochTerminationCondition(0.4),
                m.MaxEpochsTerminationCondition(100)])
        assert tr.score_vs_epoch[-1] <= 0.4
        assert tr.total_epochs < 100

    def test_local_file_saver(self, tmp_path):
        X, Y = _data(48)
        jr, tr = _fit_both(
            X, Y, 24, lambda m: [m.MaxEpochsTerminationCondition(3)],
            (JES.LocalFileModelSaver(str(tmp_path / "jax")),
             ES.LocalFileModelSaver(str(tmp_path / "port"))))
        assert (tmp_path / "port" / "bestModel.zip").exists()
        out = tr.best_model.output(X[:4])
        assert tuple(out.shape) == (4, 2)
        np.testing.assert_allclose(out.numpy(),
                                   np.asarray(jr.best_model.output(X[:4])),
                                   atol=1e-5)
        # each package restores the other's best model
        from deeplearning4j_tpu.util.serializer import ModelSerializer as JS
        from deeplearning4j_tpu_torch.util.serializer import ModelSerializer
        cross = ModelSerializer.restore(
            str(tmp_path / "jax" / "bestModel.zip"), device="cpu")
        np.testing.assert_allclose(cross.output(X[:4]).numpy(),
                                   out.numpy(), atol=1e-5)
        back = JS.restore(str(tmp_path / "port" / "bestModel.zip"))
        np.testing.assert_allclose(np.asarray(back.output(X[:4])),
                                   out.numpy(), atol=1e-5)
