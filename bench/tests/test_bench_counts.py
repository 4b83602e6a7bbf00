"""The operation and byte counters against counts made by hand at a tiny
shape: H 2 heads, N 3 nodes, B 4 slots, D 5 features, P 6 coefficients."""
from bench.counts import cheb_attn, fedgat_kernel, fedgat_vector, gat


def test_cheb_attn_forward_reads_each_input_once_and_writes_the_output_once():
    flops, nbytes = cheb_attn.forward(2, 3, 4, 5, 6)
    # x 24, h_nb 60, mask 12, coeffs 6 read; out 30 written; 4 bytes each.
    assert nbytes == 4 * (24 + 60 + 12 + 6 + 30) == 528
    # a score: Horner 2P, the mask, the denominator, the numerator 2D; a division an output
    assert flops == 24 * (12 + 1 + 1 + 10) + 30 == 606


def test_cheb_attn_backward_counts_only_the_asked_cotangents():
    flops, nbytes = cheb_attn.backward(2, 3, 4, 5, 6)
    assert nbytes == 4 * (24 + 60 + 12 + 6 + 30 + 24) == 624
    assert flops == 24 * (4 * 6 + 5 * 5 + 3) == 1248
    flops, nbytes = cheb_attn.backward(2, 3, 4, 5, 6, needs=(True, True, False, False))
    assert nbytes == 4 * (24 + 60 + 12 + 6 + 30 + 24 + 60)
    assert flops == 24 * (52 + 10)


def test_least_time_is_the_longer_of_bytes_and_operations():
    assert cheb_attn.least_seconds(0, 3.35e12) == 1.0
    assert cheb_attn.least_seconds(67e12, 1) == 1.0


def test_gat_layer_by_hand():
    # N 3, B 4, d_in 5, heads 2, d_out 6
    fwd, bwd = gat.gat_layer(3, 4, 5, 2, 6)
    assert fwd == 2 * 3 * 5 * 6 * 2 + 4 * 2 * 3 * 6 + 7 * 2 * 3 * 4 + 2 * 2 * 3 * 4 * 6 + 2 * 3 * 6
    assert bwd == 4 * 2 * 3 * 4 * 6 + 7 * 2 * 3 * 4 + 8 * 2 * 3 * 6 + 2 * (2 * 3 * 5 * 6 * 2)


def test_layer1_engines_by_hand():
    # N 3, B 4, d 5, H 2, o 6, degree p 7
    f, b = fedgat_kernel.layer1(3, 4, 5, 2, 6, 7)
    hnb = 2 * 3 * 4
    assert f == 4 * 2 * 5 * 6 + 4 * 3 * 5 * 2 + hnb * 17 + 2 * hnb * 5 + 2 * 3 * 5 + 2 * 2 * 3 * 5 * 6
    assert b == 4 * 2 * 3 * 5 * 6 + 4 * 2 * 3 * 5 + 2 * hnb * 5 + hnb * 18 + 4 * 3 * 5 * 2 + 8 * 2 * 5 * 6
    f, b = fedgat_vector.layer1(3, 4, 5, 2, 6, 7)
    nhg = 3 * 2 * 8
    assert f == 4 * 2 * 5 * 6 + 4 * 3 * 2 * 5 * 8 + nhg * 19 + 2 * nhg * 5 + 3 * 2 * 5 + 2 * 3 * 2 * 5 * 6
    assert b == 4 * 3 * 2 * 5 * 6 + 4 * 3 * 2 * 5 + 6 * nhg * 5 + nhg * 18 + 8 * 2 * 5 * 6


def test_a_round_is_its_local_steps_and_one_evaluation():
    model = {"num_layers": 2, "heads": 2, "hidden": 6, "out_heads": 1, "degree": 7}
    graph = {"num_nodes": 3, "feature_dim": 5, "num_classes": 4}
    f1, b1 = fedgat_kernel.layer1(3, 4, 5, 2, 6, 7)
    step, evaluate = gat.step_and_eval(f1, b1, model, 3, 4, 5, 4)
    assert fedgat_kernel.round_flops(model, graph, 4, 3, 2) == 6 * step + evaluate
    params = 2 * 5 * 6 + 2 * 2 * 6 + 1 * 12 * 4 + 2 * 4
    g_f, g_b = gat.gat_layer(3, 4, 12, 1, 4)
    assert step == (f1 + b1 + 2 * 3 * 12 + g_f + g_b + (4 * 12 + 6) + 3 * 12 + 14 * params)
    assert evaluate == f1 + 3 * 12 + g_f + 2 * (12 + 6)
