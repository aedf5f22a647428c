# Copied from hudiff_tpu/numbering/germline.py.
"""Human germline V/J library + CDR grafting.

Rebuilds abnumber's ``Chain.graft_cdrs_onto_human_germline`` surface
(used by the reference at antibody_scripts/sample.py:209-227, :370-376 and
for the germline-identity metric at patent_eval.py:203-213) without the
abnumber/ANARCI dependency: germline sequences are embedded as data and the
graft operates directly on the fixed IMGT grids.

The library covers the functional IMGT human germline repertoire at one-or-
more alleles per functional gene across every V family that appears in
expressed repertoires (IGHV1-7, IGKV1-6 incl. distinct-protein D-locus
duplicates, IGLV1-10) plus the complete functional J sets (IGHJ1-6 as their
four distinct FR4 proteins, IGKJ1-5, IGLJ1/2/3/6/7). Germline amino-acid
sequences are public scientific constants (IMGT/GENE-DB translations); every
entry is structurally validated in tests (grid alignment, conserved IMGT
23/104 cysteines, FR length). The cost of this library vs abnumber's full
several-hundred-allele database is MEASURED on HuAb348
(tools/germline_margin.py -> docs/germline_margin_huab348.json, with an
embedded before/after of the round-5 breadth additions): gene-grouped
best-vs-second-gene FR-identity margins, the measured identity gain from
the explicitly-added alleles, and the residual representative-allele
underreport bound (within-gene allele distance)/|FR| for genes still at
one allele (~2/80 = 2.5 identity points at the conservative 2-residue
IMGT allele scale; ~1.3 points at the typical 1-residue scale). Grafting
is insensitive at that scale: the chosen donor framework is within 1-2 FR
residues of any alternative.

Allele breadth beyond the curated entries is a DATA DROP, not a code
change: ``extend_library_from_fasta`` ingests a standard IMGT/GENE-DB
protein FASTA (or any ``>IGxV...*NN`` protein fasta) at runtime, and the
``HUDIFF_GERMLINE_FASTA`` env var auto-loads one before the first library
use — the environment this repo is built in has no network access and no
IMGT database file, so the full allele set cannot be embedded here, only
loaded when the user supplies it.

V genes cover FR1..FR3 plus the germline-encoded start of CDR3; J genes
contribute FR4 (IMGT 118-128 heavy / 118-127 light).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .. import constants as C

# ---------------------------------------------------------------------------
# Functional germline library (IMGT/GENE-DB amino-acid translations)
# ---------------------------------------------------------------------------

GERMLINE_V_HEAVY: Dict[str, str] = {
    # --- IGHV1 family ---
    'IGHV1-2*02': ('QVQLVQSGAEVKKPGASVKVSCKASGYTFTGYYMHWVRQAPGQGLEWMGWINPN'
                   'SGGTNYAQKFQGRVTMTRDTSISTAYMELSRLRSDDTAVYYCAR'),
    'IGHV1-3*01': ('QVQLVQSGAEVKKPGASVKVSCKASGYTFTSYAMHWVRQAPGQRLEWMGWINAG'
                   'NGNTKYSQKFQGRVTITRDTSASTAYMELSSLRSEDTAVYYCAR'),
    'IGHV1-8*01': ('QVQLVQSGAEVKKPGASVKVSCKASGYTFTSYDINWVRQATGQGLEWMGWMNPN'
                   'SGNTGYAQKFQGRVTMTRNTSISTAYMELSSLRSEDTAVYYCAR'),
    'IGHV1-18*01': ('QVQLVQSGAEVKKPGASVKVSCKASGYTFTSYGISWVRQAPGQGLEWMGWISA'
                    'YNGNTNYAQKLQGRVTMTTDTSTSTAYMELRSLRSDDTAVYYCAR'),
    'IGHV1-24*01': ('QVQLVQSGAEVKKPGASVKVSCKVSGYTLTELSMHWVRQAPGKGLEWMGGFDP'
                    'EDGETIYAQKFQGRVTMTEDTSTDTAYMELSSLRSEDTAVYYCAT'),
    'IGHV1-46*01': ('QVQLVQSGAEVKKPGASVKVSCKASGYTFTSYYMHWVRQAPGQGLEWMGIINP'
                    'SGGSTSYAQKFQGRVTMTRDTSTSTVYMELSSLRSEDTAVYYCAR'),
    'IGHV1-58*01': ('QMQLVQSGPEVKKPGTSVKVSCKASGFTFTSSAVQWVRQARGQRLEWIGWIVV'
                    'GSGNTNYAQKFQERVTITRDMSTSTAYMELSSLRSEDTAVYYCAA'),
    'IGHV1-69*01': ('QVQLVQSGAEVKKPGSSVKVSCKASGGTFSSYAISWVRQAPGQGLEWMGGIIP'
                    'IFGTANYAQKFQGRVTITADESTSTAYMELSSLRSEDTAVYYCAR'),
    # --- IGHV2 family ---
    'IGHV2-5*01': ('QITLKESGPTLVKPTQTLTLTCTFSGFSLSTSGVGVGWIRQPPGKALEWLALIY'
                   'WNDDKRYSPSLKSRLTITKDTSKNQVVLTMTNMDPVDTATYYCAHR'),
    'IGHV2-26*01': ('QVTLKESGPVLVKPTETLTLTCTVSGFSLSNARMGVSWIRQPPGKALEWLAHI'
                    'FSNDEKSYSTSLKSRLTISKDTSKSQVVLTMTNMDPVDTATYYCARI'),
    'IGHV2-70*01': ('QVTLRESGPALVKPTQTLTLTCTFSGFSLSTSGMCVSWIRQPPGKALEWLALI'
                    'DWDDDKYYSTSLKTRLTISKDTSKNQVVLTMTNMDPVDTATYYCARI'),
    # --- IGHV3 family ---
    'IGHV3-7*01': ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYWMSWVRQAPGKGLEWVANIKQD'
                   'GSEKYYVDSVKGRFTISRDNAKNSLYLQMNSLRAEDTAVYYCAR'),
    'IGHV3-9*01': ('EVQLVESGGGLVQPGRSLRLSCAASGFTFDDYAMHWVRQAPGKGLEWVSGISWN'
                   'SGSIGYADSVKGRFTISRDNAKNSLYLQMNSLRAEDTALYYCAKD'),
    'IGHV3-11*01': ('QVQLVESGGGLVKPGGSLRLSCAASGFTFSDYYMSWIRQAPGKGLEWVSYISS'
                    'SGSTIYYADSVKGRFTISRDNAKNSLYLQMNSLRAEDTAVYYCAR'),
    'IGHV3-13*01': ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYDMHWVRQATGKGLEWVSAIGT'
                    'AGDTYYPGSVKGRFTISRENAKNSLYLQMNSLRAGDTAVYYCAR'),
    'IGHV3-15*01': ('EVQLVESGGGLVKPGGSLRLSCAASGFTFSNAWMSWVRQAPGKGLEWVGRIKS'
                    'KTDGGTTDYAAPVKGRFTISRDDSKNTLYLQMNSLKTEDTAVYYCTT'),
    'IGHV3-20*01': ('EVQLVESGGGVVRPGGSLRLSCAASGFTFDDYGMSWVRQAPGKGLEWVSGINW'
                    'NGGSTGYADSVKGRFTISRDNAKNSLYLQMNSLRAEDTALYHCAR'),
    'IGHV3-21*01': ('EVQLVESGGGLVKPGGSLRLSCAASGFTFSSYSMNWVRQAPGKGLEWVSSISS'
                    'SSSYIYYADSVKGRFTISRDNAKNSLYLQMNSLRAEDTAVYYCAR'),
    'IGHV3-23*01': ('EVQLLESGGGLVQPGGSLRLSCAASGFTFSSYAMSWVRQAPGKGLEWVSAISG'
                    'SGGSTYYADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAK'),
    # second allele of the highest-traffic IGHV3 gene: *04 differs from *01
    # by the well-documented L5V FR1 substitution (the framework most
    # therapeutic VH3 antibodies carry)
    'IGHV3-23*04': ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYAMSWVRQAPGKGLEWVSAISG'
                    'SGGSTYYADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAK'),
    'IGHV3-30*01': ('QVQLVESGGGVVQPGRSLRLSCAASGFTFSSYAMHWVRQAPGKGLEWVAVISY'
                    'DGSNKYYADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAR'),
    'IGHV3-33*01': ('QVQLVESGGGVVQPGRSLRLSCAASGFTFSSYGMHWVRQAPGKGLEWVAVIWY'
                    'DGSNKYYADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAR'),
    'IGHV3-43*01': ('EVQLVESGGGVVQPGGSLRLSCAASGFTFDDYTMHWVRQAPGKGLEWVSLISW'
                    'DGGSTYYADSVKGRFTISRDNSKNSLYLQMNSLRTEDTALYYCAKD'),
    'IGHV3-48*01': ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYSMNWVRQAPGKGLEWVSYISS'
                    'SSSTIYYADSVKGRFTISRDNAKNSLYLQMNSLRAEDTAVYYCAR'),
    'IGHV3-49*03': ('EVQLVESGGGLVQPGRSLRLSCTASGFTFGDYAMSWFRQAPGKGLEWVGFIRS'
                    'KAYGGTTEYAASVKGRFTISRDDSKSIAYLQMNSLKTEDTAVYYCTR'),
    'IGHV3-53*01': ('EVQLVESGGGLIQPGGSLRLSCAASGFTVSSNYMSWVRQAPGKGLEWVSVIYS'
                    'GGSTYYADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAR'),
    'IGHV3-64*01': ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYAMHWVRQAPGKGLEYVSAISS'
                    'NGGSTYYADSVKGRFTISRDNSKNTLYLQMGSLRAEDMAVYYCAR'),
    'IGHV3-66*01': ('EVQLVESGGGLVQPGGSLRLSCAASGFTVSSNYMSWVRQAPGKGLEWVSVIYS'
                    'GGSTYYADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAR'),
    'IGHV3-72*01': ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSDHYMDWVRQAPGKGLEWVGRTRN'
                    'KANSYTTEYAASVKGRFTISRDDSKNSLYLQMNSLKTEDTAVYYCAR'),
    'IGHV3-73*01': ('EVQLVESGGGLVQPGGSLKLSCAASGFTFSGSAMHWVRQASGKGLEWVGRIRS'
                    'KANSYATAYAASVKGRFTISRDDSKNTAYLQMNSLKTEDTAVYYCTR'),
    'IGHV3-74*01': ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYWMHWVRQAPGKGLVWVSRINS'
                    'DGSSTSYADSVKGRFTISRDNAKNTLYLQMNSLRAEDTAVYYCAR'),
    # --- IGHV4 family ---
    'IGHV4-4*02': ('QVQLQESGPGLVKPSGTLSLTCAVSGGSISSSNWWSWVRQPPGKGLEWIGEIYH'
                   'SGSTNYNPSLKSRVTISVDKSKNQFSLKLSSVTAADTAVYYCAR'),
    'IGHV4-28*01': ('QVQLQESGPGLVKPSDTLSLTCAVSGYSISSSNWWGWIRQPPGKGLEWIGYIY'
                    'YSGSTYYNPSLKSRVTMSVDTSKNQFSLKLSSVTAVDTAVYYCAR'),
    'IGHV4-31*03': ('QVQLQESGPGLVKPSQTLSLTCTVSGGSISSGGYYWSWIRQHPGKGLEWIGYI'
                    'YYSGSTYYNPSLKSRVTISVDTSKNQFSLKLSSVTAADTAVYYCAR'),
    'IGHV4-34*01': ('QVQLQQWGAGLLKPSETLSLTCAVYGGSFSGYYWSWIRQPPGKGLEWIGEINH'
                    'SGSTNYNPSLKSRVTISVDTSKNQFSLKLSSVTAADTAVYYCAR'),
    'IGHV4-39*01': ('QLQLQESGPGLVKPSETLSLTCTVSGGSISSSSYYWGWIRQPPGKGLEWIGSI'
                    'YYSGSTYYNPSLKSRVTISVDTSKNQFSLKLSSVTAADTAVYYCAR'),
    'IGHV4-59*01': ('QVQLQESGPGLVKPSETLSLTCTVSGGSISSYYWSWIRQPPGKGLEWIGYIYY'
                    'SGSTNYNPSLKSRVTISVDTSKNQFSLKLSSVTAADTAVYYCAR'),
    'IGHV4-61*01': ('QVQLQESGPGLVKPSETLSLTCTVSGGSVSSGSYYWSWIRQPPGKGLEWIGYI'
                    'YYSGSTNYNPSLKSRVTISVDTSKNQFSLKLSSVTAADTAVYYCAR'),
    # --- IGHV5 family ---
    'IGHV5-10-1*01': ('EVQLVQSGAEVKKPGESLRISCKGSGYSFTSYWISWVRQMPGKGLEWMGRI'
                      'DPSDSYTNYSPSFQGHVTISADKSISTAYLQWSSLKASDTAMYYCAR'),
    'IGHV5-51*01': ('EVQLVQSGAEVKKPGESLKISCKGSGYSFTSYWIGWVRQMPGKGLEWMGIIYP'
                    'GDSDTRYSPSFQGQVTISADKSISTAYLQWSSLKASDTAMYYCAR'),
    # --- IGHV6 / IGHV7 families ---
    'IGHV6-1*01': ('QVQLQQSGPGLVKPSQTLSLTCAISGDSVSSNSAAWNWIRQSPSRGLEWLGRTY'
                   'YRSKWYNDYAVSVKSRITINPDTSKNQFSLQLNSVTPEDTAVYYCAR'),
    'IGHV7-4-1*02': ('QVQLVQSGSELKKPGASVKVSCKASGYTFTSYAMNWVRQAPGQGLEWMGWIN'
                     'TNTGNPTYAQGFTGRFVFSLDTSVSTAYLQICSLKAEDTAVYYCAR'),
}

GERMLINE_V_KAPPA: Dict[str, str] = {
    # --- IGKV1 family ---
    'IGKV1-5*03': ('DIQMTQSPSTLSASVGDRVTITCRASQSISSWLAWYQQKPGKAPKLLIYKASSL'
                   'ESGVPSRFSGSGSGTEFTLTISSLQPDDFATYYCQQYNSYS'),
    'IGKV1-6*01': ('AIQMTQSPSSLSASVGDRVTITCRASQGIRNDLGWYQQKPGKAPKLLIYAASSL'
                   'QSGVPSRFSGSGSGTDFTLTISSLQPEDFATYYCLQDYNYP'),
    'IGKV1-9*01': ('DIQLTQSPSFLSASVGDRVTITCRASQGISSYLAWYQQKPGKAPKLLIYAASTL'
                   'QSGVPSRFSGSGSGTEFTLTISSLQPEDFATYYCQQLNSYP'),
    'IGKV1-12*01': ('DIQMTQSPSSVSASVGDRVTITCRASQGISSWLAWYQQKPGKAPKLLIYAASS'
                    'LQSGVPSRFSGSGSGTDFTLTISSLQPEDFATYYCQQANSFP'),
    'IGKV1-16*01': ('DIQMTQSPSSLSASVGDRVTITCRASQGISNYLAWFQQKPGKAPKSLIYAASS'
                    'LQSGVPSKFSGSGSGTDFTLTISSLQPEDFATYYCQQYNSYP'),
    'IGKV1-17*01': ('DIQMTQSPSSLSASVGDRVTITCRASQGIRNDLGWYQQKPGKAPKRLIYAASS'
                    'LQSGVPSRFSGSGSGTEFTLTISSLQPEDFATYYCLQHNSYP'),
    'IGKV1-27*01': ('DIQMTQSPSSLSASVGDRVTITCRASQGISNYLAWYQQKPGKVPKLLIYAAST'
                    'LQSGVPSRFSGSGSGTDFTLTISSLQPEDVATYYCQKYNSAP'),
    'IGKV1-33*01': ('DIQMTQSPSSLSASVGDRVTITCQASQDISNYLNWYQQKPGKAPKLLIYDASN'
                    'LETGVPSRFSGSGSGTDFTFTISSLQPEDIATYYCQQYDNLP'),
    'IGKV1-39*01': ('DIQMTQSPSSLSASVGDRVTITCRASQSISSYLNWYQQKPGKAPKLLIYAASS'
                    'LQSGVPSRFSGSGSGTDFTLTISSLQPEDFATYYCQQSYSTP'),
    # --- IGKV2 family ---
    'IGKV2-24*01': ('DIVMTQTPLSSPVTLGQPASISCRSSQSLVHSDGNTYLSWLQQRPGQPPRLLI'
                    'YKISNRFSGVPDRFSGSGAGTDFTLKISRVEAEDVGVYYCMQATQFP'),
    'IGKV2-28*01': ('DIVMTQSPLSLPVTPGEPASISCRSSQSLLHSNGYNYLDWYLQKPGQSPQLLI'
                    'YLGSNRASGVPDRFSGSGSGTDFTLKISRVEAEDVGVYYCMQALQTP'),
    'IGKV2-30*01': ('DVVMTQSPLSLPVTLGQPASISCRSSQSLVYSDGNTYLNWFQQRPGQSPRRLI'
                    'YKVSNRDSGVPDRFSGSGSGTDFTLKISRVEAEDVGVYYCMQGTHWP'),
    'IGKV2-40*01': ('DIVMTQTPLSLPVTPGEPASISCRSSQSLLDSDDGNTYLDWYLQKPGQSPQLL'
                    'IYTLSYRASGVPDRFSGSGSGTDFTLKISRVEAEDVGVYYCMQRIEFP'),
    # distinct-protein D-locus duplicate of the high-traffic IGKV2-28
    # cluster (abnumber carries it as its own gene): CDR1 ..SDGKTYLY,
    # CDR2 EVS, CDR3 start MQSIQLP
    'IGKV2D-29*01': ('DIVMTQTPLSLSVTPGQPASISCKSSQSLLHSDGKTYLYWYLQKPGQSPQLL'
                     'IYEVSSRFSGVPDRFSGSGSGTDFTLKISRVEAEDVGVYYCMQSIQLP'),
    # --- IGKV3 family ---
    'IGKV3-11*01': ('EIVLTQSPATLSLSPGERATLSCRASQSVSSYLAWYQQKPGQAPRLLIYDASN'
                    'RATGIPARFSGSGSGTDFTLTISSLEPEDFAVYYCQQRSNWP'),
    'IGKV3-15*01': ('EIVMTQSPATLSVSPGERATLSCRASQSVSSNLAWYQQKPGQAPRLLIYGAST'
                    'RATGIPARFSGSGSGTEFTLTISSLQSEDFAVYYCQQYNNWP'),
    'IGKV3-20*01': ('EIVLTQSPGTLSLSPGERATLSCRASQSVSSSYLAWYQQKPGQAPRLLIYGAS'
                    'SRATGIPDRFSGSGSGTDFTLTISRLEPEDFAVYYCQQYGSSP'),
    # distinct-protein D-locus duplicate of IGKV3-20 (G9A in FR1)
    'IGKV3D-20*01': ('EIVLTQSPATLSLSPGERATLSCRASQSVSSSYLAWYQQKPGQAPRLLIYGA'
                     'SSRATGIPDRFSGSGSGTDFTLTISRLEPEDFAVYYCQQYGSSP'),
    # --- IGKV4 / IGKV5 / IGKV6 families ---
    'IGKV4-1*01': ('DIVMTQSPDSLAVSLGERATINCKSSQSVLYSSNNKNYLAWYQQKPGQPPKLLI'
                   'YWASTRESGVPDRFSGSGSGTDFTLTISSLQAEDVAVYYCQQYYSTP'),
    'IGKV5-2*01': ('ETTLTQSPAFMSATPGDKVNISCKASQDIDDDMNWYQQKPGEAAIFIIQEATTL'
                   'VPGIPPRFSGSGYGTDFTLTINNIESEDAAYYFCLQHDNFP'),
    'IGKV6-21*01': ('EIVLTQSPDFQSVTPKEKVTITCRASQSIGSSLHWYQQKPDQSPKLLIKYASQ'
                    'SFSGVPSRFSGSGSGTDFTLTINSLEAEDAATYYCHQSSSLP'),
}

GERMLINE_V_LAMBDA: Dict[str, str] = {
    # --- IGLV1 family ---
    'IGLV1-36*01': ('QSVLTQPPSVSEAPRQRVTISCSGSSSNIGNNAVNWYQQLPGKAPKLLIYYDD'
                    'LLPSGVSDRFSGSKSGTSASLAISGLQSEDEADYYCAAWDDSLNG'),
    'IGLV1-40*01': ('QSVLTQPPSVSGAPGQRVTISCTGSSSNIGAGYDVHWYQQLPGTAPKLLIYGN'
                    'SNRPSGVPDRFSGSKSGTSASLAITGLQAEDEADYYCQSYDSSLSG'),
    'IGLV1-44*01': ('QSVLTQPPSASGTPGQRVTISCSGSSSNIGSNTVNWYQQLPGTAPKLLIYSNN'
                    'QRPSGVPDRFSGSKSGTSASLAISGLQSEDEADYYCAAWDDSLNG'),
    'IGLV1-47*01': ('QSVLTQPPSASGTPGQRVTISCSGSSSNIGSNYVYWYQQLPGTAPKLLIYRNN'
                    'QRPSGVPDRFSGSKSGTSASLAISGLRSEDEADYYCAAWDDSLSG'),
    'IGLV1-51*01': ('QSVLTQPPSVSAAPGQKVTISCSGSSSNIGNNYVSWYQQLPGTAPKLLIYDNN'
                    'KRPSGIPDRFSGSKSGTSATLGITGLQTGDEADYYCGTWDSSLSA'),
    # --- IGLV2 family ---
    'IGLV2-8*01': ('QSALTQPPSASGSPGQSVTISCTGTSSDVGGYNYVSWYQQHPGKAPKLMIYEVS'
                   'KRPSGVPDRFSGSKSGNTASLTVSGLQAEDEADYYCSSYAGSNN'),
    'IGLV2-14*01': ('QSALTQPASVSGSPGQSITISCTGTSSDVGGYNYVSWYQQHPGKAPKLMIYDV'
                    'SNRPSGVSNRFSGSKSGNTASLTISGLQAEDEADYYCSSYTSSSTL'),
    # second allele of the high-traffic IGLV2-14: *03 carries the A8R +
    # I18V FR1 polymorphism
    'IGLV2-14*03': ('QSALTQPRSVSGSPGQSVTISCTGTSSDVGGYNYVSWYQQHPGKAPKLMIYDV'
                    'SNRPSGVSNRFSGSKSGNTASLTISGLQAEDEADYYCSSYTSSSTL'),
    'IGLV2-18*02': ('QSALTQPASVSGSPGQSITISCTGTSSDVGSYNLVSWYQQHPGKAPKLMIYEG'
                    'SKRPSGVSNRFSGSKSGNTASLTISGLQAEDEADYYCSSYTSSST'),
    'IGLV2-23*02': ('QSALTQPASVSGSPGQSITISCTGTSSDVGSYNLVSWYQQHPGKAPKLMIYEV'
                    'SNRPSGVSNRFSGSKSGNTASLTISGLQAEDEADYYCCSYAGSST'),
    # --- IGLV3 family ---
    'IGLV3-1*01': ('SYELTQPPSVSVSPGQTASITCSGDKLGDKYACWYQQKPGQSPVLVIYQDSKRP'
                   'SGIPERFSGSNSGNTATLTISGTQAMDEADYYCQAWDSSTA'),
    'IGLV3-10*01': ('SYELTQPPSVSVSPGQTARITCSGDALPKQYAYWYQQKPGQAPVLVIYKDSER'
                    'PSGIPERFSGSSSGTTVTLTISGVQAEDEADYYCQSADSSGTY'),
    'IGLV3-19*01': ('SSELTQDPAVSVALGQTVRITCQGDSLRSYYASWYQQKPGQAPVLVIYGKNNR'
                    'PSGIPDRFSGSSSGNTASLTITGAQAEDEADYYCNSRDSSGNH'),
    'IGLV3-21*01': ('SYVLTQPPSVSVAPGQTARITCGGNNIGSKSVHWYQQKPGQAPVLVVYDDSDR'
                    'PSGIPERFSGSNSGNTATLTISRVEAGDEADYYCQVWDSSSDH'),
    'IGLV3-25*03': ('SYELTQPPSVSVSPGQTARITCSGDALPKKYAYWYQQKSGQAPVLVIYEDSKR'
                    'PSGIPERFSGSSSGTMATLTISGAQVEDEADYYCYSTDSSGNH'),
    # --- IGLV4 / IGLV5 families ---
    'IGLV4-69*01': ('QLPVLTQPPSASALLGASIKLTCTLSSEHSTYTIEWYQQRPGRSPQYIMKVK'
                    'SDGSHSKGDGIPDRFMGSSSGADRYLTFSNLQSDDEAEYHCGESHTIDGQVG'),
    'IGLV5-45*02': ('QAVLTQPASLSASPGASASLTCTLRSGINVGTYRIYWYQQKPGSPPQYLLRY'
                    'KSDSDKQQGSGVPSRFSGSKDASANAGILLISGLQSEDEADYYCMIWHSSA'),
    # --- IGLV6 / IGLV7 / IGLV8 families ---
    'IGLV6-57*01': ('NFMLTQPHSVSESPGKTVTISCTRSSGSIASNYVQWYQQRPGSSPTTVIYEDN'
                    'QRPSGVPDRFSGSIDSSSNSASLTISGLKTEDEADYYCQSYDSSN'),
    'IGLV7-43*01': ('QTVVTQEPSLTVSPGGTVTLTCASSTGAVTSGYYPNWFQQKPGQAPRALIYST'
                    'SNKHSWTPARFSGSLLGGKAALTLSGVQPEDEAEYYCLLYYGGAQ'),
    'IGLV7-46*01': ('QAVVTQEPSLTVSPGGTVTLTCGSSTGAVTSGHYPYWFQQKPGQAPRTLIYDT'
                    'SNKHSWTPARFSGSLLGGKAALTLSGAQPEDEAEYYCLLSYSGAR'),
    'IGLV8-61*01': ('QTVVTQEPSFSVSPGGTVTLTCGLSSGSVSTSYYPSWYQQTPGQAPRTLIYST'
                    'NTRSSGVPDRFSGSILGNKAALTITGAQADDESDYYCVLYMGSGIS'),
    # --- IGLV9 / IGLV10 families ---
    'IGLV9-49*01': ('QPVLTQPPSASASLGASVKLTCTLSSGHSSYAIAWHQQQPEKGPRYLMKLNS'
                    'DGSHSKGDGIPDRFSGSSSGAERYLTISSLQSEDEADYYCQTWGTGI'),
    'IGLV10-54*01': ('QAGLTQPPSVSKGLRQTATLTCTGNSNNVGNQGAAWLQQHQGHPPKLLSYR'
                     'NNNRPSGISERLSASRSGNTASLTITGLQPEDEADYYCSAWDSSLSA'),
}

# J-gene FR4 contributions: heavy = IMGT 118-128 (11 residues),
# light = IMGT 118-127 (10 residues). Complete functional sets; IGHJ1/4/5
# and IGKJ alleles sharing one FR4 protein appear once under the gene whose
# name abnumber reports for it.
GERMLINE_J_HEAVY: Dict[str, str] = {
    'IGHJ2*01': 'WGRGTLVTVSS',
    'IGHJ3*02': 'WGQGTMVTVSS',
    'IGHJ4*01': 'WGQGTLVTVSS',   # = IGHJ1 / IGHJ5 FR4 protein
    'IGHJ6*01': 'WGQGTTVTVSS',
}
GERMLINE_J_KAPPA: Dict[str, str] = {
    'IGKJ1*01': 'FGQGTKVEIK',
    'IGKJ2*01': 'FGQGTKLEIK',
    'IGKJ3*01': 'FGPGTKVDIK',
    'IGKJ4*01': 'FGGGTKVEIK',
    'IGKJ5*01': 'FGQGTRLEIK',
}
GERMLINE_J_LAMBDA: Dict[str, str] = {
    'IGLJ1*01': 'FGTGTKVTVL',
    'IGLJ2*01': 'FGGGTKLTVL',   # = IGLJ3*01 FR4 protein
    'IGLJ6*01': 'FGSGTKVTVL',
    'IGLJ7*01': 'FGGGTQLTVL',
}

_V_BY_GROUP = {'H': GERMLINE_V_HEAVY, 'K': GERMLINE_V_KAPPA,
               'L': GERMLINE_V_LAMBDA}
_J_BY_GROUP = {'H': GERMLINE_J_HEAVY, 'K': GERMLINE_J_KAPPA,
               'L': GERMLINE_J_LAMBDA}

_FR4_LEN = {'H': 11, 'K': 10, 'L': 10}

# gridded germline cache: group -> {name: np.ndarray of grid chars}
_GRID_CACHE: Dict[str, Dict[str, np.ndarray]] = {}


def gene_of(allele: str) -> str:
    """Gene name of an allele ('IGHV3-23*04' -> 'IGHV3-23'). D-locus
    duplicates keep their own gene name, as abnumber reports them."""
    return allele.split('*', 1)[0]


def extend_library_from_fasta(path: str) -> int:
    """Load additional germline V alleles from a protein FASTA.

    Accepts IMGT/GENE-DB headers ('>ACC|IGHV1-2*02|Homo sapiens|F|V-REGION
    |...' — only functionality 'F' entries are taken) or plain
    '>IGHV1-2*02' headers (all taken). IMGT alignment gaps ('.') and '-'
    are stripped. Entries whose gene locus is not IGHV/IGKV/IGLV, that
    duplicate an existing allele name, or that fail to place on the IMGT
    grid are skipped. Returns the number of alleles added.

    This is the file-drop path to abnumber-level allele breadth
    (reference sample.py:370-376 grafts against abnumber's full IMGT
    allele database): the build environment carries no IMGT database, so
    full breadth loads at runtime from the user's IMGT download.
    """
    from . import imgt as IMGT
    added = 0
    name, chunks = None, []

    def _take(name: str, seq: str) -> int:
        if not name or not seq:
            return 0
        for prefix, group in (('IGHV', 'H'), ('IGKV', 'K'), ('IGLV', 'L')):
            if name.startswith(prefix):
                break
        else:
            return 0
        lib = _V_BY_GROUP[group]
        if name in lib:
            return 0
        placed = IMGT.grid_string(seq + _CHAIN_CONTEXT[group],
                                  heavy=group == 'H', chain_hint=group)
        if placed is None:
            return 0
        lib[name] = seq
        _GRID_CACHE.pop(group, None)
        return 1

    with open(path, encoding='UTF-8') as f:
        for line in f:
            line = line.strip()
            if line.startswith('>'):
                added += _take(name, ''.join(chunks))
                fields = line[1:].split('|')
                if len(fields) >= 4:  # IMGT/GENE-DB header
                    name = fields[1].strip()
                    # functionality may be annotated '(F)' (by cloning) or
                    # '[F]' (by comparison) in IMGT/GENE-DB headers
                    if fields[3].strip().strip('()[]') != 'F':
                        name = None  # pseudogene / ORF: skip
                else:
                    name = fields[0].split()[0]
                chunks = []
            elif line:
                chunks.append(line.replace('.', '').replace('-', '')
                              .replace('*', '').upper())
    added += _take(name, ''.join(chunks))
    return added


_ENV_FASTA_LOADED = False


def _maybe_load_env_fasta() -> None:
    """One-shot auto-load of HUDIFF_GERMLINE_FASTA before first library use."""
    global _ENV_FASTA_LOADED
    if _ENV_FASTA_LOADED:
        return
    _ENV_FASTA_LOADED = True
    import os
    path = os.environ.get('HUDIFF_GERMLINE_FASTA')
    if not path:
        return
    if os.path.exists(path):
        extend_library_from_fasta(path)
    else:
        import warnings
        warnings.warn(f'HUDIFF_GERMLINE_FASTA={path!r} does not exist; '
                      'falling back to the curated germline library')


# Representative CDR3 stub + J FR4 appended when gridding library V genes:
# queries are always full chains, and the NW aligner can place a bare V
# fragment differently from the same gene inside a full chain (long-CDR
# genes especially). The stub/J slots are never read: nearest_v compares
# FR1-FR3 only and graft_cdrs overwrites CDR + FR4 slots.
_CHAIN_CONTEXT = {'H': 'DYW' + 'GQGTLVTVSS', 'K': 'LT' + 'FGQGTKVEIK',
                  'L': 'VL' + 'FGGGTKLTVL'}


def _gridded_library(group: str) -> Dict[str, np.ndarray]:
    """Place every germline V of a group on its fixed IMGT grid (cached),
    aligned in full-chain context so placements match query chains."""
    _maybe_load_env_fasta()
    if group in _GRID_CACHE:
        return _GRID_CACHE[group]
    from . import imgt as IMGT
    heavy = group == 'H'
    out = {}
    for name, seq in _V_BY_GROUP[group].items():
        placed = IMGT.grid_string(seq + _CHAIN_CONTEXT[group], heavy=heavy,
                                  chain_hint=group)
        if placed is None:  # pragma: no cover - library members must align
            continue
        out[name] = np.asarray(list(placed['grid']))
    _GRID_CACHE[group] = out
    return out


def _cdr_mask(heavy: bool) -> np.ndarray:
    return (C.HEAVY_CDR_INDEX if heavy else C.LIGHT_CDR_INDEX) != 0


def _vernier_mask(heavy: bool) -> np.ndarray:
    tab = C.HEAVY_CDR_KABAT_VERNIER if heavy else C.LIGHT_CDR_KABAT_VERNIER
    return np.asarray(tab) == 5


def v_gene_scores(grid: np.ndarray, group: str) -> Dict[str, float]:
    """FR1-FR3 identity of the query grid against EVERY library V gene.

    The full score vector (not just the argmax) is what lets the
    selection-robustness study (tools/germline_margin.py) measure how far
    the best gene leads the runner-up — the margin that bounds the effect
    of representing each gene by one allele instead of abnumber's full
    allele set."""
    heavy = group == 'H'
    fr = ~_cdr_mask(heavy)
    fr4 = np.zeros_like(fr)
    fr4[-_FR4_LEN[group]:] = True
    fr_v = fr & ~fr4  # V gene covers FR1-FR3 only
    scores = {}
    for name, g in _gridded_library(group).items():
        occ = fr_v & ((grid != '-') | (g != '-'))
        if occ.sum() == 0:
            continue
        scores[name] = float((grid[occ] == g[occ]).mean())
    return scores


def group_allele_scores(allele_scores: Dict[str, float],
                        exclude: frozenset = frozenset()) -> Dict[str, float]:
    """Fold per-allele scores into per-GENE max (the one grouping rule,
    shared with tools/germline_margin.py). ``exclude``: allele names to
    leave out (the margin study's before/after comparison)."""
    out: Dict[str, float] = {}
    for name, s in allele_scores.items():
        if name in exclude:
            continue
        g = gene_of(name)
        if s > out.get(g, -1.0):
            out[g] = s
    return out


def gene_scores(grid: np.ndarray, group: str) -> Dict[str, float]:
    """FR1-FR3 identity per GENE = max over that gene's library alleles.

    The gene-grouped view is what the margin study ranks: with multiple
    alleles of one gene in the library, ranking raw allele scores would
    report a same-gene allele pair as a 'margin', which is not a selection
    ambiguity at all."""
    return group_allele_scores(v_gene_scores(grid, group))


def nearest_v(grid: np.ndarray, group: str) -> Tuple[str, np.ndarray]:
    """Nearest germline V gene by framework identity on the IMGT grid
    (abnumber picks its graft donor the same way: highest-identity human
    germline)."""
    scores = v_gene_scores(grid, group)
    if not scores:
        raise ValueError(f'no germline aligned for group {group}')
    best_name = max(scores, key=scores.get)
    return best_name, _gridded_library(group)[best_name]


def nearest_j(grid: np.ndarray, group: str) -> Tuple[str, str]:
    """Nearest germline J gene by FR4 identity."""
    n = _FR4_LEN[group]
    tail = grid[-n:]
    best_name, best_fr4, best_score = None, None, -1.0
    for name, fr4 in _J_BY_GROUP[group].items():
        score = float((tail == np.asarray(list(fr4))).mean())
        if score > best_score:
            best_name, best_fr4, best_score = name, fr4, score
    return best_name, best_fr4


def graft_cdrs(grid: np.ndarray, group: str,
               backmutate_vernier: bool = False
               ) -> Dict[str, object]:
    """CDR-graft a parental chain onto its nearest human germline.

    Equivalent of abnumber's ``Chain.graft_cdrs_onto_human_germline(
    backmutate_vernier=...)`` (reference sample.py:216, :374-375) on the
    fixed IMGT grid: germline FR1-FR3 + J-gene FR4 as acceptor, parental
    CDRs (and optionally parental vernier-zone residues) as donor.

    Returns {'grid', 'v_gene', 'j_gene'}; 'grid' is a char array with '-'
    at unoccupied slots.
    """
    grid = np.asarray(grid)
    heavy = group == 'H'
    v_name, v_grid = nearest_v(grid, group)
    j_name, j_fr4 = nearest_j(grid, group)
    cdr = _cdr_mask(heavy)
    out = v_grid.copy()
    out[cdr] = grid[cdr]
    n = _FR4_LEN[group]
    out[-n:] = list(j_fr4)
    if backmutate_vernier:
        vern = _vernier_mask(heavy) & (grid != '-')
        out[vern] = grid[vern]
    return {'grid': out, 'v_gene': v_name, 'j_gene': j_name}


def graft_seq(seq: str, group: Optional[str] = None,
              backmutate_vernier: bool = False) -> Dict[str, object]:
    """Sequence-level graft: align, graft, return the grafted sequence and
    the FR slots where the parental residue already equals the graft
    (the 'identity positions' the reference inpaint init keeps fixed,
    sample.py:217-226)."""
    from . import align as AL
    from . import imgt as IMGT
    if group is None:
        scores = AL.profile_scores(seq)
        group, profile, _ = AL.detect_chain_type(seq, scores)
        if group != 'H':
            # light chain: re-type by direct K-vs-L comparison and surface
            # low-margin (borderline lambda) calls instead of trusting the
            # overall-best profile silently (same alignment pass)
            group, margin = AL.classify_light(seq, scores)
            AL.warn_ambiguous_light(group, margin,
                                    context='selects the graft V library')
    heavy = group == 'H'
    placed = IMGT.grid_string(seq, heavy=heavy, chain_hint=group)
    if placed is None:
        raise ValueError(f'unalignable chain: {seq[:20]}...')
    par = np.asarray(list(placed['grid']))
    res = graft_cdrs(par, group, backmutate_vernier=backmutate_vernier)
    g = res['grid']
    identity = (par == g) & (par != '-')
    return {'grid': g, 'seq': ''.join(g[g != '-']), 'group': group,
            'parental_grid': par, 'identity_slots': identity,
            'v_gene': res['v_gene'], 'j_gene': res['j_gene']}


def fr_identity_grid(par: np.ndarray, group: str) -> float:
    """FR identity between a gridded chain and its own germline graft —
    the ONE implementation behind both germline_fr_identity (sequence
    surface) and eval.metrics.germline_identity (GridChain surface)
    (patent_eval.cal_group_fr_germline_identity, :203-213)."""
    par = np.asarray(par)
    g = graft_cdrs(par, group)['grid']
    fr = ~_cdr_mask(heavy=group == 'H')
    occ = fr & ((par != '-') | (g != '-'))
    if occ.sum() == 0:
        return 0.0
    return float((par[occ] == g[occ]).mean())


def germline_fr_identity(seq: str, group: Optional[str] = None) -> float:
    """Sequence-level wrapper over fr_identity_grid; scores against the V
    library of the group graft_seq resolved (a lambda chain with group=None
    is scored against the lambda library, not defaulted to kappa)."""
    res = graft_seq(seq, group)
    return fr_identity_grid(res['parental_grid'], res['group'])


def cdr_pair_grafting(h_seq: str, l_seq: str, back_mutation: bool = False
                      ) -> Tuple[str, str]:
    """Classic CDR-graft baseline for a pair (reference cdr_pair_grafting,
    sample.py:370-376)."""
    from . import align as AL
    h = graft_seq(h_seq, 'H', backmutate_vernier=back_mutation)
    l_group, _ = AL.classify_light(l_seq)
    l = graft_seq(l_seq, l_group, backmutate_vernier=back_mutation)
    return h['seq'], l['seq']
