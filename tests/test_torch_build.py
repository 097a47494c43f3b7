"""The kernel build's log readers, on the CPU: ``kernel_label`` names the
mangled kernel functions that ptxas and ``cuobjdump -sass`` print (the
per-function register and tensor-core counts of ``chip_smoke.py``), and
``compiler_log`` gives one ptxas line per kernel function."""
import pytest

from repro_torch.kernels import _build

BF16_DQ = ("_ZN8flash_tc18flash_dq_tc_kernelILi128ELi2EEEv14CUtensorMap_st"
           "S1_S1_S1_PKfS3_P13__nv_bfloat16iiiiiiiff")
F32_DKV = ("_ZN12_GLOBAL__N_116flash_dkv_kernelIfLi80EEEvPKT_S3_S3_S3_PKfS5_"
           "PS1_S6_iiiiiif")


@pytest.mark.parametrize("mangled,label", [
    (BF16_DQ, "flash_dq_tc_kernel<128, 2>"),
    (F32_DKV, "flash_dkv_kernel<float, 80>"),
    ("_ZN8flash_tc19flash_fwd_tc_kernelILi80ELi1ELb1EEEv14CUtensorMap_stS1_"
     "S1_P13__nv_bfloat16Pfiiiiiif", "flash_fwd_tc_kernel<80, 1, 1>"),
    ("_ZN12_GLOBAL__N_113decode_kernelI13__nv_bfloat16Li64EEEvPKT_",
     "decode_kernel<__nv_bfloat16, 64>"),
    ("_ZN12repro_decode13decode_kernelI13__nv_bfloat16aLi128ELb1EEEvPKT_"
     "PKS3_S6_PKS1_S8_PKiSA_PS2_iiiiiif",
     "decode_kernel<__nv_bfloat16, int8_t, 128, 1>"),
    ("_ZN18repro_decode_split19decode_split_kernelILi80ELb0EEEvPK13__nv_"
     "bfloat16S3_S3_PKiS5_PS1_PfS7_S7_iiiiiiif",
     "decode_split_kernel<80, 0>"),
    # the split block's element type of K/V: bf16, and int8 (K3, K7)
    ("_ZN18repro_decode_split19decode_split_kernelI13__nv_bfloat16Li80ELb0E"
     "EEvPKS1_PKT_S6_S3_S3_PKiS8_PS1_PfSA_SA_iiiiiiif",
     "decode_split_kernel<__nv_bfloat16, 80, 0>"),
    ("_ZN18repro_decode_split19decode_split_kernelIaLi128ELb1EEEvPK13__nv_"
     "bfloat16PKT_S6_S3_S3_PKiS8_PS1_PfSA_SA_iiiiiiif",
     "decode_split_kernel<int8_t, 128, 1>"),
    ("_Z8ssd_scanPKf", "ssd_scan"),
    # the SSD scan's kernel functions, as chip_smoke.SSD_FAMILIES reads them
    ("_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_ssd_scan18ssd_scan_tc_kernel"
     "IfLi128EEEvPKT_PKfS5_S3_S3_S5_S5_PS1_Pfiiiii",
     "ssd_scan_tc_kernel<float, 128>"),
    ("_ZN44_GLOBAL__N__70402df9_11_ssd_scan_cu_ssd_scan13ssd_cb_kernelI13__"
     "nv_bfloat16EEvPKT_S4_Pfiii", "ssd_cb_kernel<__nv_bfloat16>"),
    ("not_mangled", "not_mangled"),
])
def test_kernel_label(mangled, label):
    assert _build.kernel_label(mangled) == label


def test_compiler_log_one_line_per_kernel_function(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{BF16_DQ}' for 'sm_90a'",
        f"ptxas info    : Function properties for {BF16_DQ}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers, 48 bytes "
        "smem, 1536 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{F32_DKV}' for 'sm_90a'",
        f"ptxas info    : Function properties for {F32_DKV}",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 432 bytes "
        "cmem[0]",
    ])
    assert _build.compiler_log("flash_attention_bwd") == []
    _build.library_path("flash_attention_bwd").with_suffix(".log") \
        .write_text(log)
    assert _build.compiler_log("flash_attention_bwd") == [
        "flash_dq_tc_kernel<128, 2>: Used 168 registers, used 16 barriers, "
        "48 bytes smem, 1536 bytes cmem[0]; 0 bytes stack frame, 0 bytes "
        "spill stores, 0 bytes spill loads",
        "flash_dkv_kernel<float, 80>: Used 128 registers, used 1 barriers, "
        "432 bytes cmem[0]; 8 bytes stack frame, 4 bytes spill stores, 4 "
        "bytes spill loads"]
